"""ray_tpu_torch.data shuffle-backed relations: groupby/aggregate, sort,
random_shuffle, zip/union, actor-pool compute — the twin of
`tests/test_data_shuffle.py`, test for test, on the port's data package.

Mirrors the reference's aggregation tests (python/ray/data/tests/
test_all_to_all.py, test_sort.py): correctness vs numpy ground truth at
>1 partition, both local (no runtime) and remote (tasks/actors) paths.
The runtime fixtures are this file's own, on the port's runtime.
"""
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.aggregate import Count, Max, Mean, Min, Std, Sum


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


def _make_ds(n=200, parts=5, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 13, size=n)
    vals = rng.normal(size=n)
    return (rd.from_numpy({"k": keys, "v": vals},
                          override_num_blocks=parts), keys, vals)


def _ground_truth(keys, vals, fn):
    return {int(k): fn(vals[keys == k]) for k in np.unique(keys)}


# ------------------------------------------------------------ groupby
def test_groupby_aggregates_local():
    ds, keys, vals = _make_ds()
    out = ds.groupby("k").aggregate(
        Count(), Sum("v"), Min("v"), Max("v"), Mean("v"), Std("v"))
    rows = out.take_all()
    assert len(rows) == len(np.unique(keys))
    gt_mean = _ground_truth(keys, vals, np.mean)
    gt_std = _ground_truth(keys, vals, lambda v: np.std(v, ddof=1))
    for r in rows:
        k = int(r["k"])
        assert r["count()"] == int((keys == k).sum())
        np.testing.assert_allclose(r["sum(v)"], vals[keys == k].sum())
        np.testing.assert_allclose(r["min(v)"], vals[keys == k].min())
        np.testing.assert_allclose(r["max(v)"], vals[keys == k].max())
        np.testing.assert_allclose(r["mean(v)"], gt_mean[k])
        np.testing.assert_allclose(r["std(v)"], gt_std[k], rtol=1e-10)


def test_groupby_string_keys_multi_partition():
    names = ["ab", "cd", "ef", "gh"] * 25
    vals = np.arange(100.0)
    ds = rd.from_numpy({"name": np.array(names, dtype=object),
                        "v": vals}, override_num_blocks=4)
    rows = ds.groupby("name").sum("v").take_all()
    got = {r["name"]: r["sum(v)"] for r in rows}
    for nm in set(names):
        want = vals[[i for i, x in enumerate(names) if x == nm]].sum()
        np.testing.assert_allclose(got[nm], want)


def test_groupby_multi_key():
    ds = rd.from_numpy({"a": np.array([0, 0, 1, 1, 0]),
                        "b": np.array([0, 1, 0, 1, 0]),
                        "v": np.array([1., 2., 3., 4., 5.])},
                       override_num_blocks=2)
    rows = ds.groupby(["a", "b"]).sum("v").take_all()
    got = {(int(r["a"]), int(r["b"])): r["sum(v)"] for r in rows}
    assert got == {(0, 0): 6.0, (0, 1): 2.0, (1, 0): 3.0, (1, 1): 4.0}


def test_groupby_map_groups():
    ds, keys, vals = _make_ds(60, parts=3)
    out = ds.groupby("k").map_groups(
        lambda g: {"k": g["k"][:1], "spread": [g["v"].max() - g["v"].min()]})
    rows = out.take_all()
    gt = _ground_truth(keys, vals, lambda v: v.max() - v.min())
    assert {int(r["k"]): pytest.approx(r["spread"]) for r in rows} == \
        {k: pytest.approx(v) for k, v in gt.items()}


def test_groupby_remote(ray_cluster):
    ds, keys, vals = _make_ds(120, parts=4)
    rows = ds.groupby("k").mean("v").take_all()
    gt = _ground_truth(keys, vals, np.mean)
    assert len(rows) == len(gt)
    for r in rows:
        np.testing.assert_allclose(r["mean(v)"], gt[int(r["k"])])


def test_unique():
    ds = rd.from_numpy({"x": np.array([3, 1, 2, 3, 1, 3])},
                       override_num_blocks=3)
    assert sorted(ds.unique("x")) == [1, 2, 3]


# ----------------------------------------------------- global aggregate
def test_global_aggregates():
    ds, _, vals = _make_ds(80, parts=4)
    np.testing.assert_allclose(ds.sum("v"), vals.sum())
    np.testing.assert_allclose(ds.mean("v"), vals.mean())
    np.testing.assert_allclose(ds.min("v"), vals.min())
    np.testing.assert_allclose(ds.max("v"), vals.max())
    np.testing.assert_allclose(ds.std("v"), np.std(vals, ddof=1),
                               rtol=1e-10)


# ----------------------------------------------------------------- sort
def test_sort_local_multi_partition():
    ds, _, vals = _make_ds(150, parts=6)
    got = [r["v"] for r in ds.sort("v").take_all()]
    np.testing.assert_allclose(got, np.sort(vals))
    got_d = [r["v"] for r in ds.sort("v", descending=True).take_all()]
    np.testing.assert_allclose(got_d, np.sort(vals)[::-1])


def test_sort_remote(ray_cluster):
    ds, _, vals = _make_ds(100, parts=4, seed=7)
    got = [r["v"] for r in ds.sort("v").take_all()]
    np.testing.assert_allclose(got, np.sort(vals))


def test_sort_preserves_row_alignment():
    ds = rd.from_numpy({"k": np.array([3, 1, 2]),
                        "tag": np.array(["c", "a", "b"], dtype=object)},
                       override_num_blocks=2)
    rows = ds.sort("k").take_all()
    assert [r["tag"] for r in rows] == ["a", "b", "c"]


# ------------------------------------------------------- random shuffle
def test_random_shuffle_is_permutation():
    ds = rd.range(100, override_num_blocks=5)
    rows = [r["id"] for r in ds.random_shuffle(seed=3).take_all()]
    assert sorted(rows) == list(range(100))
    assert rows != list(range(100))


# ------------------------------------------------------------ zip/union
def test_zip_aligned():
    a = rd.from_numpy({"x": np.arange(10)}, override_num_blocks=3)
    b = rd.from_numpy({"y": np.arange(10) * 2}, override_num_blocks=2)
    rows = a.zip(b).take_all()
    assert all(r["y"] == 2 * r["x"] for r in rows)


def test_zip_name_collision_and_mismatch():
    a = rd.from_numpy({"x": np.arange(4)})
    b = rd.from_numpy({"x": np.arange(4) + 10})
    rows = a.zip(b).take_all()
    assert [r["x_1"] - r["x"] for r in rows] == [10] * 4
    c = rd.from_numpy({"x": np.arange(5)})
    # surfaces directly (local) or wrapped in TaskError (remote worker)
    with pytest.raises(Exception, match="row counts"):
        a.zip(c).take_all()


def test_union_fuses_op_chains():
    a = rd.range(5).map(lambda r: {"id": r["id"] * 10})
    b = rd.range(3)
    rows = sorted(r["id"] for r in a.union(b).take_all())
    assert rows == [0, 0, 1, 2, 10, 20, 30, 40]
    assert a.union(b).count() == 8


# ----------------------------------------------------- actor-pool compute
class _Enricher:
    """Stateful transform: counts how many batches this instance saw."""

    def __init__(self, offset):
        self.offset = offset
        self.calls = 0

    def __call__(self, batch):
        self.calls += 1
        import os
        return {"id": batch["id"] + self.offset,
                "pid": np.full(len(batch["id"]), os.getpid()),
                "call": np.full(len(batch["id"]), self.calls)}


def test_map_batches_callable_class():
    ds = rd.range(40, override_num_blocks=4).map_batches(
        _Enricher, fn_constructor_args=(100,))
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(100, 140))
    # stateful: some instance saw more than one partition (single local
    # cache -> 4; actor pool of 2 -> >=2)
    assert max(r["call"] for r in rows) > 1


def test_map_batches_actor_pool_remote(ray_cluster):
    import os
    ds = rd.range(60, override_num_blocks=6).map_batches(
        _Enricher, fn_constructor_args=(1000,),
        compute=rd.ActorPoolStrategy(size=2))
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(1000, 1060))
    pids = {int(r["pid"]) for r in rows}
    assert os.getpid() not in pids       # ran on actors
    assert len(pids) <= 2                # pool-sized
    # statefulness: some actor processed >1 partition with the SAME
    # instance (calls > 1 observed)
    assert max(int(r["call"]) for r in rows) > 1


# --------------------------------------------- review-finding regressions
def test_single_partition_shuffle_remote(ray_cluster):
    """num_out == 1 exchange: sort/groupby on a 1-partition dataset must
    not crash (num_returns=1 stores the whole list as one object)."""
    ds = rd.from_numpy({"k": np.array([2, 1, 2]),
                        "v": np.array([1., 2., 3.])},
                       override_num_blocks=1)
    got = [r["k"] for r in ds.sort("k").take_all()]
    assert got == [1, 2, 2]
    rows = ds.groupby("k", num_partitions=1).sum("v").take_all()
    assert {int(r["k"]): r["sum(v)"] for r in rows} == {1: 2.0, 2: 4.0}


def test_groupby_negative_zero_key():
    """-0.0 and 0.0 are equal keys and must land in ONE group even when
    scattered across partitions."""
    ds = rd.from_numpy({"k": np.array([0.0, -0.0, 1.0, -0.0]),
                        "v": np.array([1., 2., 3., 4.])},
                       override_num_blocks=4)
    rows = ds.groupby("k").sum("v").take_all()
    got = {float(r["k"]): r["sum(v)"] for r in rows}
    assert got == {0.0: 7.0, 1.0: 3.0}


def test_std_large_mean_stability():
    """Catastrophic cancellation guard: values ~1e8 with std ~1."""
    rng = np.random.default_rng(0)
    vals = 1e8 + rng.normal(size=400)
    keys = np.repeat([0, 1], 200)
    ds = rd.from_numpy({"k": keys, "v": vals}, override_num_blocks=4)
    rows = ds.groupby("k").std("v").take_all()
    for r in rows:
        want = np.std(vals[keys == int(r["k"])], ddof=1)
        np.testing.assert_allclose(r["std(v)"], want, rtol=1e-6)
    np.testing.assert_allclose(ds.std("v"), np.std(vals, ddof=1),
                               rtol=1e-6)


def test_seeded_shuffle_decorrelates_equal_named_partitions():
    """from_items names every task identically; seeded shuffles must
    still draw DIFFERENT bucket streams per partition (review
    regression: name-derived seeds co-located row i of every
    partition)."""
    ds = rd.from_items(list(range(100)), override_num_blocks=5)
    out = ds.random_shuffle(seed=3)
    blocks = list(out.iter_blocks())
    # same-index rows of the 5 input partitions (0,20,40,60,80):
    # with per-index seeds they almost surely spread across blocks
    landing = {}
    for bi, b in enumerate(blocks):
        for v in b["item"]:
            landing[int(v)] = bi
    aligned = {landing[i] for i in (0, 20, 40, 60, 80)}
    assert len(aligned) > 1, landing
    # determinism under the same seed
    again = [int(v) for b in ds.random_shuffle(seed=3).iter_blocks()
             for v in b["item"]]
    first = [int(v) for b in blocks for v in b["item"]]
    assert again == first
