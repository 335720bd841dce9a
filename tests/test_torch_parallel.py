"""The port's parallel layer (`ray_tpu_torch.parallel`): twins of the
mesh, sharding and collective cases of `tests/test_parallel.py`, on gloo
CPU ranks.

The JAX cases run on 8 virtual devices of one process; here each rank is
a process of a module-scoped pool of 4 (`torch_ranks.RankPool`), and a
case that used 8 devices keeps the axes it made nontrivial at a smaller
size (each twin says what it keeps). The three pipeline cases of that
file wait for ROADMAP queue 1, item 9.
"""
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.parallel import prepare_mesh as jprepare_mesh
from ray_tpu.parallel.sharding import logical_sharding as jlogical_sharding
from ray_tpu_torch.parallel import MeshSpec, param_shardings, shard_pytree
from ray_tpu_torch.parallel.mesh import _split_hybrid
from ray_tpu_torch.parallel.sharding import logical_spec

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import RankPool  # noqa: E402

RANKS = 4


@pytest.fixture(scope="module", autouse=True)
def ranks():
    # autouse: the ranks start with the module's first test, and the
    # first case that runs on them waits for whatever is left of it
    pool = RankPool(RANKS)
    yield pool
    pool.close()


def test_mesh_resolve_wildcard():
    assert MeshSpec(dp=-1, tp=2).resolve(8) == (1, 4, 1, 1, 1, 2)
    assert MeshSpec(dp=2, fsdp=2, tp=2).resolve(8) == (1, 2, 2, 1, 1, 2)
    with pytest.raises(ValueError):
        MeshSpec(dp=3).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(dp=-1, fsdp=-1).resolve(8)


def test_unknown_logical_axis_raises():
    with pytest.raises(ValueError, match="unknown logical axis"):
        logical_spec(("embd",))


def test_split_hybrid_factors_outer_axis():
    # (pp, dp, fsdp, sp, ep, tp) = (1, 4, 2, 1, 1, 1), 2 hosts of 4.
    dcn, ici = _split_hybrid((1, 4, 2, 1, 1, 1), 2, 4)
    assert dcn == (1, 2, 1, 1, 1, 1)
    assert ici == (1, 2, 2, 1, 1, 1)


def test_split_hybrid_rejects_inner_only_mesh():
    with pytest.raises(ValueError, match="hosts"):
        # All axes trivial except tp (innermost, in-host only): the 2
        # hosts have nowhere to go.
        _split_hybrid((1, 1, 1, 1, 1, 2), 2, 1)


def _mesh(**axes):
    from ray_tpu_torch.parallel import prepare_mesh
    return prepare_mesh(MeshSpec(**axes), device="cpu")


def _rank():
    import torch.distributed as dist
    return dist.get_rank()


def _mesh_axes():
    m = _mesh(dp=2, tp=2)
    return dict(zip(m.mesh_dim_names, m.shape)), m.size()


def test_prepare_mesh_axes(ranks):
    # JAX: dp=4, tp=2 over 8 devices; here dp=2, tp=2 over 4 ranks, the
    # same two nontrivial axes, and every other axis of AXIS_ORDER kept
    # at size 1
    for sizes, size in ranks.run(RANKS, _mesh_axes):
        assert sizes == {"pp": 1, "dp": 2, "fsdp": 1, "sp": 1, "ep": 1,
                         "tp": 2}
        assert size == 4


def _specs():
    m = _mesh(dp=4)
    return (logical_spec(("embed", "mlp"), mesh=m),
            logical_spec(("batch", "seq"), mesh=m))


def test_logical_spec_drops_trivial_axes(ranks):
    # JAX: dp=8; here dp=4: tp is size 1, so the mlp axis replicates
    for trivial, batch in ranks.run(RANKS, _specs):
        assert trivial == (None, None)
        assert batch == ("dp", None)


def _placed():
    m = _mesh(fsdp=2, tp=2)
    logical = {"w": ("embed", "mlp"), "b": ("mlp",)}
    sh = param_shardings(m, logical)
    params = {"w": np.arange(8 * 16, dtype=np.float32).reshape(8, 16),
              "b": np.zeros(16, np.float32)}
    placed = shard_pytree(params, sh)
    rows = shard_pytree(
        {"x": np.arange(8, dtype=np.float32)},
        param_shardings(_mesh(dp=2, fsdp=2), {"x": ("batch",)}))["x"]
    coord = rows.device_mesh.get_coordinate()
    return (sh["w"].spec, tuple(placed["w"].placements),
            placed["w"].full_tensor().numpy(), tuple(placed["w"].to_local()
                                                     .shape),
            coord, rows.to_local().numpy())


def test_param_shardings_and_placement(ranks):
    # JAX: dp=2, fsdp=2, tp=2 over 8 devices, the leaf over (fsdp, tp);
    # here fsdp=2, tp=2 over 4 ranks, the same two axes of the leaf
    w = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    # rows split over (dp, fsdp): each rank holds the rows its JAX
    # device at the same mesh coordinate holds (dp outer, fsdp inner)
    jmesh = jprepare_mesh(dp=2, fsdp=2, devices=jax.devices()[:4])
    jrows = jlogical_sharding(jmesh, ("batch",)).devices_indices_map((8,))
    devs = jmesh.devices            # (pp, dp, fsdp, sp, ep, tp)
    for spec, placements, full, local, coord, rows in ranks.run(RANKS,
                                                               _placed):
        assert spec == ("fsdp", "tp")
        assert placements == (Shard(0), Shard(1))
        np.testing.assert_array_equal(full, w)
        assert local == (4, 8)
        dp, fsdp = coord
        want = np.arange(8)[jrows[devs[0, dp, fsdp, 0, 0, 0]][0]]
        np.testing.assert_array_equal(rows, want)


def _collectives():
    from ray_tpu_torch.parallel import collectives as c
    m = _mesh(dp=4)
    x = torch.tensor([float(_rank())])
    return (c.allreduce(x, "dp", mesh=m).item(),
            c.allgather(x, "dp", mesh=m).tolist(),
            c.ppermute_ring(x, "dp", shift=1, mesh=m).item(),
            c.broadcast(x, "dp", root=3, mesh=m).item())


def test_collectives_in_shard_map(ranks):
    # JAX: dp=8, one element a device; here dp=4, one element a rank
    got = ranks.run(RANKS, _collectives)
    for rank, (s, g, r, b) in enumerate(got):
        assert s == 6.0
        assert g == [0.0, 1.0, 2.0, 3.0]
        # ring shift: rank i receives from i-1 (src i sends to i+1)
        assert r == float((rank - 1) % RANKS)
        assert b == 3.0


def _reducescatter():
    from ray_tpu_torch.parallel import collectives as c
    m = _mesh(dp=4)
    local = torch.arange(16.0)[4 * _rank():4 * _rank() + 4]
    return c.reducescatter(local, "dp", mesh=m).tolist()


def test_reducescatter(ranks):
    # JAX: 64 elements over dp=8; here 16 over dp=4: element d of the
    # sum lands on rank d, sum_k x[4k + d] = 24 + 4d
    out = [v for r in ranks.run(RANKS, _reducescatter) for v in r]
    assert len(out) == 4
    np.testing.assert_allclose(out, 24.0 + 4.0 * np.arange(4))


def _constraint():
    from ray_tpu_torch.parallel import with_logical_constraint
    m = _mesh(dp=2, tp=2)
    x = torch.ones((8, 4))
    out = with_logical_constraint(x * 2, ("batch", "mlp"), mesh=m)
    return tuple(out.placements), out.full_tensor().numpy()


def test_with_logical_constraint_in_jit(ranks):
    # JAX: dp=4, tp=2; here dp=2, tp=2: batch over dp, mlp over tp
    for placements, full in ranks.run(RANKS, _constraint):
        assert placements == (Shard(0), Shard(1))
        np.testing.assert_allclose(full, np.full((8, 4), 2.0))


def _broadcast_nan():
    from ray_tpu_torch.parallel import collectives as c
    m = _mesh(dp=4)
    x = torch.tensor([float("nan") if _rank() == 1 else float(_rank())])
    return c.broadcast(x, "dp", root=3, mesh=m).item()


def test_broadcast_ignores_nonroot_nan(ranks):
    assert ranks.run(RANKS, _broadcast_nan) == [3.0] * RANKS


def _send_recv():
    from ray_tpu_torch.parallel import collectives as c
    m = _mesh(dp=4)
    x = torch.tensor([10.0 + _rank()])
    return c.send_recv(x, "dp", [(0, 1)], mesh=m).item()


def test_send_recv_nonparticipants_keep_buffers(ranks):
    assert ranks.run(RANKS, _send_recv) == [10.0, 10.0, 12.0, 13.0]


def _barrier():
    from ray_tpu_torch.parallel import collectives as c
    m = _mesh(dp=4)
    if _rank() == 0:
        time.sleep(0.5)
    t0 = time.perf_counter()
    out = c.barrier("dp", {"x": torch.tensor([float(_rank())])}, mesh=m)
    waited = time.perf_counter() - t0
    return out["x"].item(), waited, c.barrier("dp", mesh=m).item()


def test_barrier_threads_value(ranks):
    got = ranks.run(RANKS, _barrier)
    assert [x for x, _, _ in got] == [0.0, 1.0, 2.0, 3.0]
    assert all(token == 0 for _, _, token in got)
    # the fence is a real collective: the ranks that did not sleep waited
    # for rank 0's half second
    assert min(w for _, w, _ in got[1:]) > 0.3


def _ulysses():
    from ray_tpu_torch.parallel import collectives as c
    m = _mesh(sp=4)
    x = torch.arange(4 * 16 * 4.0).reshape(4, 16, 4)   # (seq, heads, d)
    local = x[_rank():_rank() + 1]                      # (1, 16, 4)
    return c.all_to_all(local, "sp", split_dim=1, concat_dim=0,
                        mesh=m).numpy()


def test_all_to_all_ulysses(ranks):
    # seq-split -> head-split re-layout, the Ulysses primitive. JAX: sp=8
    # over (8, 16, 4); here sp=4 over (4, 16, 4); each rank ends with the
    # whole sequence of its quarter of the heads, so the content is kept
    # in place, a stronger check than the JAX case's sorted comparison
    x = np.arange(4 * 16 * 4.0).reshape(4, 16, 4)
    outs = ranks.run(RANKS, _ulysses)
    assert all(o.shape == (4, 4, 4) for o in outs)
    np.testing.assert_array_equal(np.concatenate(outs, axis=1), x)


# ---------------------------------------------------------- hybrid mesh


def _fake_hosts():
    from ray_tpu_torch.parallel import mesh as mesh_mod
    calls = {}
    real = mesh_mod._split_hybrid

    def spy(shape, n_hosts, per_host):
        calls["dcn"], calls["ici"] = real(shape, n_hosts, per_host)
        return calls["dcn"], calls["ici"]
    saved = mesh_mod._rank_hosts, mesh_mod._split_hybrid
    # ranks 0, 1 on host a; ranks 2, 3 on host b
    mesh_mod._rank_hosts = lambda world: ["a", "a", "b", "b"]
    mesh_mod._split_hybrid = spy
    try:
        m = mesh_mod.prepare_mesh(MeshSpec(dp=2, tp=2), device="cpu")
    finally:
        mesh_mod._rank_hosts, mesh_mod._split_hybrid = saved
    return calls, dict(zip(m.mesh_dim_names, m.shape)), m.mesh.tolist()


def test_prepare_mesh_hybrid_path_with_fake_slices(ranks):
    """Ranks on distinct hosts route through the hybrid layout with the
    (cross-host, in-host) factorisation. JAX: dp=4, tp=2 over 2 fake
    slices of 4 devices; here dp=2, tp=2 over 2 fake hosts of 2 ranks:
    dp spans the hosts, tp stays within each."""
    for calls, sizes, layout in ranks.run(RANKS, _fake_hosts):
        assert calls["dcn"] == (1, 2, 1, 1, 1, 1)   # dp split over hosts
        assert calls["ici"] == (1, 1, 1, 1, 1, 2)
        assert sizes["dp"] == 2 and sizes["tp"] == 2
        # dp index = host: host a's ranks (0, 1) form the dp=0 row
        assert np.asarray(layout).reshape(2, 2).tolist() == [[0, 1], [2, 3]]


# ------------------------------------------------------- the port's own
def _grads():
    from ray_tpu_torch.parallel import collectives as c
    m = _mesh(dp=4)
    r = _rank()
    x = torch.tensor([1.0 + r], requires_grad=True)
    # ring: rank r's value goes to r+1, whose loss weighs it by (r+2)
    y = c.ppermute_ring(x, "dp", mesh=m) * (r + 1.0)
    g = c.allgather(x, "dp", mesh=m)
    (y.sum() + (g * torch.arange(1.0, 5.0)).sum()).backward()
    return x.grad.item()


def test_collective_gradients_follow_local_map_convention(ranks):
    """ppermute's backward is the reverse pass; allgather's (a value
    every rank holds whole) takes the rank's own slice of the whole
    cotangent."""
    got = ranks.run(RANKS, _grads)
    for r, g in enumerate(got):
        assert g == pytest.approx(((r + 1) % RANKS + 1.0) + (r + 1.0))


def _wrappers_on_a_dtensor():
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.ops.norms import rms_norm
    from ray_tpu_torch.parallel.mesh import compute_mesh
    mesh = compute_mesh(_mesh())
    q = distribute_tensor(torch.ones(1, 2, 8, 16), mesh, [Replicate()])
    w = distribute_tensor(torch.zeros(16), mesh, [Replicate()])
    errors = []
    for call in (lambda: flash_attention(q, q, q),
                 lambda: rms_norm(q, w)):
        try:
            call()
        except TypeError as e:
            errors.append(str(e))
    return errors


def test_kernel_wrappers_refuse_a_dtensor(ranks):
    """No wrapper falls back to its plain version for a DTensor: under a
    mesh the kernels run on local shards (`ops/sharded.py`)."""
    errors = ranks.run(1, _wrappers_on_a_dtensor)[0]
    assert len(errors) == 2 and all("local shards" in e for e in errors)
