"""Runtime environments: pip venvs, py_modules via KV, env-keyed worker
reuse.

Mirrors the reference's runtime_env tests (python/ray/tests/
test_runtime_env_*): real subprocess workers materialize envs from
specs; pip is exercised OFFLINE against a locally-built wheel
(--no-index --find-links), matching this environment's no-egress rule.

The port's twin of `tests/test_runtime_env.py`, case for case.
"""
import os
import textwrap
import zipfile

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.runtime_env import env_hash


# --------------------------------------------------------------- units


@pytest.fixture()
def ray_cluster():
    """The conftest fixture of the same name, on the port: reuses a live
    runtime or (re)creates one; the module's end shuts it down."""
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    """The conftest shuts the JAX runtime down at the session's end; the
    port's goes down at this module's end, so no later file finds it up."""
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


def test_env_hash_stability_and_identity():
    a = {"env_vars": {"X": "1"}, "working_dir": "/tmp"}
    assert env_hash(a) == env_hash(dict(reversed(list(a.items()))))
    assert env_hash(a) != env_hash({"env_vars": {"X": "2"},
                                    "working_dir": "/tmp"})
    assert env_hash(None) is None and env_hash({}) is None


def test_validate_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unsupported runtime_env"):
        ray_tpu_torch.remote(runtime_env={"mystery_plugin": "x"})(lambda: 1)


# ----------------------------------------------------------- py_modules
def _write_module(tmp_path, name: str, body: str) -> str:
    pkg = tmp_path / name
    pkg.mkdir()
    (pkg / "__init__.py").write_text(textwrap.dedent(body))
    return str(pkg)


def test_py_modules_import_on_workers(ray_cluster, tmp_path):
    """A driver-local package ships through the cluster KV and imports
    inside workers that never saw the driver's filesystem layout."""
    mod = _write_module(tmp_path, "shiny_mod", """
        VALUE = 41
        def bump(x):
            return x + VALUE
    """)

    @ray_tpu_torch.remote(runtime_env={"py_modules": [mod]})
    def use_it(x):
        import shiny_mod
        return shiny_mod.bump(x), shiny_mod.__file__

    val, path = ray_tpu_torch.get(use_it.remote(1), timeout=60)
    assert val == 42
    # imported from the per-host cache, not the driver's tmp_path
    assert "runtime_envs" in path and str(tmp_path) not in path


def test_py_modules_actor(ray_cluster, tmp_path):
    mod = _write_module(tmp_path, "actor_mod", "TAG = 'amod'\n")

    @ray_tpu_torch.remote(runtime_env={"py_modules": [mod]})
    class Holder:
        def tag(self):
            import actor_mod
            return actor_mod.TAG

    h = Holder.remote()
    assert ray_tpu_torch.get(h.tag.remote(), timeout=60) == "amod"


# ------------------------------------------------------------------ pip
def _build_wheel(tmp_path) -> str:
    """A minimal pure-python wheel, built by hand (a wheel is a zip)."""
    name, version = "tinydep", "1.0.0"
    whl = tmp_path / f"{name}-{version}-py3-none-any.whl"
    dist = f"{name}-{version}.dist-info"
    meta = (f"Metadata-Version: 2.1\nName: {name}\n"
            f"Version: {version}\n")
    wheel_meta = ("Wheel-Version: 1.0\nGenerator: test\n"
                  "Root-Is-Purelib: true\nTag: py3-none-any\n")
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}/__init__.py",
                    "ANSWER = 7\n\ndef triple(x):\n    return 3 * x\n")
        zf.writestr(f"{dist}/METADATA", meta)
        zf.writestr(f"{dist}/WHEEL", wheel_meta)
        zf.writestr(f"{dist}/RECORD", "")
    return str(tmp_path)


@pytest.mark.slow        # ~22s (builds a wheel + venv); the other
                         # runtime_env plugins (py_modules/uv/env
                         # switch/container) stay in tier-1
def test_pip_runtime_env_offline_wheel(ray_cluster, tmp_path):
    """pip env: a venv is materialized per spec hash (offline via
    --no-index + local wheel) and the package imports inside workers."""
    links = _build_wheel(tmp_path)

    @ray_tpu_torch.remote(runtime_env={"pip": {
        "packages": ["tinydep"],
        "pip_install_options": ["--no-index", "--find-links", links]}})
    def use_dep(x):
        import tinydep
        return tinydep.triple(x) + tinydep.ANSWER

    assert ray_tpu_torch.get(use_dep.remote(5), timeout=120) == 22


# ------------------------------------------------- env-keyed worker reuse
def test_worker_reuse_keyed_by_env_hash(ray_cluster, tmp_path):
    """Sequential tasks with the SAME runtime env land on the same
    pooled worker (no env churn); a different env prefers a different
    or re-switched worker — and values never leak between envs."""
    env_a = {"env_vars": {"RTPU_TEST_ENV": "A"}}
    env_b = {"env_vars": {"RTPU_TEST_ENV": "B"}}

    @ray_tpu_torch.remote
    def probe():
        return os.getpid(), os.environ.get("RTPU_TEST_ENV")

    fa = ray_tpu_torch.remote(runtime_env=env_a)(probe._fn)
    fb = ray_tpu_torch.remote(runtime_env=env_b)(probe._fn)

    pids_a = [ray_tpu_torch.get(fa.remote(), timeout=60) for _ in range(4)]
    assert all(v == "A" for _, v in pids_a)
    # same-env tasks reuse one worker (sequential submits, idle pool)
    assert len({pid for pid, _ in pids_a}) == 1

    pid_b, v_b = ray_tpu_torch.get(fb.remote(), timeout=60)
    assert v_b == "B"
    # and a no-env task on that worker must NOT see either env var
    plain = ray_tpu_torch.get(probe.remote(), timeout=60)
    assert plain[1] is None


def test_env_switch_purges_stale_modules(ray_cluster, tmp_path):
    """Two envs shipping DIFFERENT versions of the same package: a
    reused worker must never serve the old version (review regression:
    sys.modules survived the env switch)."""
    for v in (1, 2):
        d = tmp_path / f"v{v}" / "dupmod"
        d.mkdir(parents=True)
        (d / "__init__.py").write_text(f"VERSION = {v}\n")

    def read_version():
        import dupmod
        return dupmod.VERSION

    f1 = ray_tpu_torch.remote(runtime_env={
        "py_modules": [str(tmp_path / "v1" / "dupmod")]})(read_version)
    f2 = ray_tpu_torch.remote(runtime_env={
        "py_modules": [str(tmp_path / "v2" / "dupmod")]})(read_version)
    # interleave so worker reuse across envs is likely
    for _ in range(3):
        assert ray_tpu_torch.get(f1.remote(), timeout=60) == 1
        assert ray_tpu_torch.get(f2.remote(), timeout=60) == 2


def test_actor_does_not_inherit_previous_task_env(ray_cluster):
    """Review regression: a pooled worker's still-applied task env must
    not leak into an actor created on it."""
    @ray_tpu_torch.remote
    def set_env_task():
        return os.environ.get("LEAKY_VAR")

    tagged = ray_tpu_torch.remote(
        runtime_env={"env_vars": {"LEAKY_VAR": "leaked"}})(
            set_env_task._fn)
    assert ray_tpu_torch.get(tagged.remote(), timeout=60) == "leaked"

    @ray_tpu_torch.remote
    class Plain:
        def leak(self):
            return os.environ.get("LEAKY_VAR")

    # several attempts so one lands on the tainted pooled worker
    for _ in range(3):
        a = Plain.remote()
        assert ray_tpu_torch.get(a.leak.remote(), timeout=60) is None
        ray_tpu_torch.kill(a)


# ------------------------------------------- plugin breadth (uv/conda/
# container) — gated on host binaries; tests use stubs for the engines
def test_uv_env_builds_via_uv_binary(ray_cluster, tmp_path):
    """{'uv': [...]} drives the uv binary (stubbed here) and injects
    the resulting site-packages (reference runtime_env/uv.py)."""
    stub = tmp_path / "uv"
    stub.write_text("""#!/bin/sh
set -e
if [ "$1" = venv ]; then
  d="$3"
  mkdir -p "$d/bin" "$d/lib/python3/site-packages"
  : > "$d/bin/python"
elif [ "$1" = pip ]; then
  # uv pip install --python <venv>/bin/python pkgs...
  venv=$(dirname $(dirname "$4"))
  echo "MAGIC = 'from-uv'" > "$venv/lib/python3/site-packages/uv_fake_mod.py"
fi
""")
    stub.chmod(0o755)

    @ray_tpu_torch.remote(runtime_env={
        "env_vars": {"RAY_TPU_UV_BIN": str(stub)},
        "uv": ["somepkg==1.0"]})
    def use_uv():
        import uv_fake_mod
        return uv_fake_mod.MAGIC

    assert ray_tpu_torch.get(use_uv.remote(), timeout=120) == "from-uv"


def test_uv_missing_binary_is_a_clear_error(ray_cluster):
    @ray_tpu_torch.remote(runtime_env={
        "env_vars": {"PATH": "/nonexistent"}, "uv": ["x"]})
    def f():
        return 1

    with pytest.raises(Exception, match="uv"):
        ray_tpu_torch.get(f.remote(), timeout=120)


def test_conda_gated_with_clear_error(ray_cluster):
    @ray_tpu_torch.remote(runtime_env={
        "env_vars": {"PATH": "/nonexistent"},
        "conda": "definitely-missing-env"})
    def f():
        return 1

    with pytest.raises(Exception, match="conda"):
        ray_tpu_torch.get(f.remote(), timeout=120)


def test_container_worker_spawned_through_engine(ray_cluster, tmp_path,
                                                 monkeypatch):
    """A container runtime_env wraps the worker SPAWN in the container
    engine (reference image_uri plugin: the worker starts inside the
    image). Engine stubbed: records the invocation, then execs the
    inner worker command as 'inside' the image."""
    log = tmp_path / "engine.log"
    stub = tmp_path / "engine"
    stub.write_text(f"""#!/bin/sh
echo "$@" >> {log}
while [ $# -gt 0 ] && [ "$1" != "fakeimg:1" ]; do shift; done
shift
exec "$@"
""")
    stub.chmod(0o755)
    monkeypatch.setenv("RAY_TPU_CONTAINER_RUNTIME", str(stub))

    @ray_tpu_torch.remote(runtime_env={"container": {"image": "fakeimg:1"}})
    def inside():
        import os
        return os.environ.get("RAY_TPU_WORKER_ID")

    wid1 = ray_tpu_torch.get(inside.remote(), timeout=120)
    assert wid1
    entry = log.read_text()
    assert "run --rm --network host" in entry
    assert "fakeimg:1" in entry
    # same-image tasks reuse the container-bound worker
    wid2 = ray_tpu_torch.get(inside.remote(), timeout=120)
    assert wid2 == wid1

    # plain tasks never land on the container-bound worker
    @ray_tpu_torch.remote
    def plain():
        import os
        return os.environ.get("RAY_TPU_WORKER_ID")

    for _ in range(4):
        assert ray_tpu_torch.get(plain.remote(), timeout=120) != wid1


def test_validate_rejects_unknown_keys_still(ray_cluster):
    with pytest.raises(ValueError, match="unsupported runtime_env"):
        @ray_tpu_torch.remote(runtime_env={"bogus_key": 1})
        def f():
            return 1
