"""The port's driver entry point, `ray_tpu_torch/graft_entry.py`, against
the repo root's `__graft_entry__.py`.

`entry(device="cpu")`'s forward step is fed the JAX `entry()`'s own
parameters (`PRNGKey(0)`, carried across by `models/convert.py::
params_from_jax`) and the same tokens, and its logits are held to the
JAX forward's: in f32 at `_flagship_config(dtype="float32")`, and at the
entry's own bf16. `_provision_devices` is the twin of the JAX one. The
other two cases of `tests/test_graft_entry.py`, the mesh specs and
`dryrun_multichip(8)`, are twinned in `tests/test_torch_sharded_train.py`
(`test_mesh_specs_cover_all_axes`, `test_dryrun_multichip_8`), on the
`ray_tpu_torch.dryrun` functions that `graft_entry` re-exports.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import Transformer as JTransformer
from ray_tpu_torch import dryrun, graft_entry
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import Transformer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Tolerances, relative to max|logit| of the JAX forward (~2 at these
# weights), set from the arithmetic before the first run:
#  * f32: the same weights and ops in another summation order, through 8
#    layers: a few f32 ulps a layer, far below 1e-4 (1.6e-6 measured).
#  * bf16: each package rounds every activation to bf16 (2^-8 relative)
#    at its own points (the JAX flash kernel's reference and the port's
#    plain version tile and sum differently), so a rounding may flip at
#    any of ~20 tensors a layer; 5e-2 of max|logit| allows that over 8
#    layers (1.1e-2 measured), and the argmax must agree on 90% of rows.
F32_REL, BF16_REL, BF16_ARGMAX = 1e-4, 5e-2, 0.9


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The forward's elementwise ops crawl when this process's full
    OpenMP pool competes with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_entry():
    import __graft_entry__ as g
    fn, (params, tokens) = g.entry()
    return g, fn, params, tokens


def _port_params(jparams, config):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           config, device="cpu")


def test_entry_matches_jax_f32(jax_entry):
    """The flagship model in f32, the port's `Transformer.apply` (what
    `entry`'s step runs) against the JAX one."""
    g, _, jparams, jtokens = jax_entry
    jmodel = JTransformer(g._flagship_config(dtype="float32"))
    want = np.asarray(jax.jit(jmodel.apply)(jparams, jtokens))
    cfg = graft_entry._flagship_config(dtype="float32")
    with torch.no_grad():
        got = Transformer(cfg).apply(
            _port_params(jparams, cfg),
            torch.from_numpy(np.array(jtokens)).long()).numpy()
    assert got.shape == want.shape == (2, 256, 32000)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= F32_REL, err


def test_entry_matches_jax_bf16(jax_entry):
    """`entry("cpu")`'s step at the entry's own bf16, its tokens the JAX
    entry's and its params replaced by the JAX entry's."""
    g, jfn, jparams, jtokens = jax_entry
    want = np.asarray(jax.jit(jfn)(jparams, jtokens), dtype=np.float32)
    fn, (_, tokens) = graft_entry.entry("cpu")
    assert torch.equal(tokens, torch.from_numpy(np.array(jtokens)).long())
    got = fn(_port_params(jparams, graft_entry._flagship_config()),
             tokens).numpy()
    assert got.dtype == np.float32 and got.shape[:2] == jtokens.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BF16_REL, err
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= BF16_ARGMAX, agree


def test_entry_config_is_the_jax_flagship():
    import dataclasses

    import __graft_entry__ as g
    assert (dataclasses.asdict(graft_entry._flagship_config())
            == dataclasses.asdict(g._flagship_config()))
    cfg = graft_entry._flagship_config()
    assert cfg.head_dim == 64 and cfg.remat and cfg.dtype == "bfloat16"


def test_entry_needs_a_card_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_provision_devices_cpu():
    devs = graft_entry._provision_devices(8)
    assert len(devs) == 8
    assert all(d.type in ("cpu", "cuda") for d in devs)


def test_reexports_the_dry_run():
    assert graft_entry.dryrun_multichip is dryrun.dryrun_multichip
    assert graft_entry._mesh_specs_for is dryrun._mesh_specs_for
