"""Remote-driver client + multiprocessing Pool + joblib backend: the twin
of `tests/test_client_shims.py`, case for case, on the port.

A SECOND process connects to the head over TCP as a driver
(`ray_tpu_torch.init(address=...)`, `ray_tpu_torch/util/client.py`) and
must import neither JAX nor torch before its first task; Pool and joblib
run real workloads on actors. The runtime fixtures are this file's own,
and a live port runtime is shut down when the module ends.
"""
import os
import subprocess
import sys
import textwrap

import pytest

import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


@pytest.fixture()
def fresh_cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    yield rt
    ray_tpu_torch.shutdown()


# --------------------------------------------------------------- client
def test_remote_driver_client(fresh_cluster):
    """A separate process connects via ray_tpu_torch.init(address=...)
    and uses tasks, actors, put/get, and named-actor lookup against this
    head (reference util/client ray:// mode); it has imported neither
    JAX nor torch before its first task, nor after its last."""
    host, port = fresh_cluster.address

    # a named actor the client will look up
    @ray_tpu_torch.remote
    class Board:
        def __init__(self):
            self.v = {}

        def set(self, k, v):
            self.v[k] = v
            return "ok"

        def get(self, k):
            return self.v.get(k)

    board = Board.options(name="board").remote()
    ray_tpu_torch.get(board.set.remote("seed", 7))

    script = textwrap.dedent(f"""
        import sys
        import ray_tpu_torch
        ctx = ray_tpu_torch.init(address="{host}:{port}")
        assert ctx.is_connected()

        def heavy():
            return sorted(n for n in ("jax", "torch") if n in sys.modules)

        print("BEFORE", heavy())

        @ray_tpu_torch.remote
        def double(x):
            return 2 * x

        print("TASKS", ray_tpu_torch.get([double.remote(i) for i in range(4)]))

        ref = ray_tpu_torch.put({{"from": "client"}})
        print("PUTGET", ray_tpu_torch.get(ref)["from"])

        b = ray_tpu_torch.get_actor("board")
        print("NAMED", ray_tpu_torch.get(b.get.remote("seed")))
        ray_tpu_torch.get(b.set.remote("reply", 42))
        print("AFTER", heavy())
        ray_tpu_torch.shutdown()
        print("DONE")
    """)
    env = dict(os.environ)
    env.pop("RAY_TPU_SESSION", None)     # a client is its own session
    env.pop("RAY_TPU_TORCH_SESSION", None)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BEFORE []" in out.stdout
    assert "TASKS [0, 2, 4, 6]" in out.stdout
    assert "PUTGET client" in out.stdout
    assert "NAMED 7" in out.stdout
    assert "AFTER []" in out.stdout
    assert "DONE" in out.stdout
    # the client's actor mutation is visible head-side
    assert ray_tpu_torch.get(board.get.remote("reply"), timeout=30) == 42


# ----------------------------------------------------------------- Pool
def _sq(x):
    return x * x


def test_multiprocessing_pool_map_variants(ray_cluster):
    from ray_tpu_torch.util.multiprocessing import Pool
    with Pool(processes=2) as p:
        assert p.map(_sq, range(10)) == [x * x for x in range(10)]
        assert p.starmap(pow, [(2, 3), (3, 2)]) == [8, 9]
        assert list(p.imap(_sq, range(6), chunksize=2)) == [
            0, 1, 4, 9, 16, 25]
        assert sorted(p.imap_unordered(_sq, range(6))) == [
            0, 1, 4, 9, 16, 25]
        assert p.apply(_sq, (7,)) == 49
        ar = p.map_async(_sq, range(4))
        assert ar.get(timeout=60) == [0, 1, 4, 9]
        assert ar.ready() and ar.successful()


def test_multiprocessing_pool_initializer_and_errors(ray_cluster):
    from ray_tpu_torch.util.multiprocessing import Pool

    def init_env(tag):
        os.environ["POOL_TAG"] = tag

    def read_tag(_):
        return os.environ.get("POOL_TAG")

    with Pool(processes=2, initializer=init_env,
              initargs=("hello",)) as p:
        assert set(p.map(read_tag, range(4))) == {"hello"}

        def boom(x):
            raise RuntimeError("pool-err")
        with pytest.raises(Exception, match="pool-err"):
            p.map(boom, [1, 2])
        ar = p.map_async(boom, [1])
        ar.wait(60)
        assert ar.ready() and not ar.successful()
    with pytest.raises(ValueError, match="not running"):
        p.map(_sq, [1])


# ---------------------------------------------------------------- joblib
# `slow` in the JAX file (~15 s there); about a second on the port
def test_joblib_backend(ray_cluster):
    joblib = pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import register_ray
    register_ray()
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=2):
        out = joblib.Parallel()(
            joblib.delayed(_sq)(i) for i in range(8))
    assert out == [i * i for i in range(8)]


def _slowsq(x):
    import time as _t
    _t.sleep(0.3)
    return x * x


def test_pool_close_join_returns_inflight_results(ray_cluster):
    """stdlib contract: close() + join() lets pending work finish, so a
    prior map_async still yields its results."""
    from ray_tpu_torch.util.multiprocessing import Pool
    p = Pool(processes=2)
    ar = p.map_async(_slowsq, range(6))
    p.close()
    p.join()
    assert ar.get(timeout=60) == [x * x for x in range(6)]
