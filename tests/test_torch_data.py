"""ray_tpu_torch.data: blocks, datasets, streaming execution, train
ingestion — the twin of `tests/test_data.py`, test for test, run on the
port's data package and its own runtime.

The two `iter_jax_batches` cases become `iter_torch_batches` cases on
the CPU (`device="cpu"`; the card's are in `tests/test_torch_kernels.py`),
and the trainer case runs `TorchTrainer`. The runtime fixtures are this
file's own: `ray_cluster` reuses a live port runtime or starts one with
`ray_tpu_torch.init(num_cpus=4)`, and the runtime is shut down when the
module ends.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.block import (block_concat, block_from_rows,
                                      block_num_rows, block_slice, block_take,
                                      rebatch_blocks)


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


# ------------------------------------------------------------- blocks
def test_block_from_rows_and_back():
    rows = [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]
    blk = block_from_rows(rows)
    assert blk["a"].tolist() == [1, 2]
    assert list(blk["b"]) == ["x", "y"]
    from ray_tpu_torch.data.block import block_to_rows
    assert [dict(r) for r in block_to_rows(blk)][0]["a"] == 1


def test_block_from_rows_heterogeneous_keys():
    """Optional JSONL fields: union of keys, None-filled (object col)."""
    rows = [{"a": 1, "b": 2}, {"a": 3}, {"a": 4, "c": 9}]
    blk = block_from_rows(rows)
    assert set(blk) == {"a", "b", "c"}
    assert blk["a"].tolist() == [1, 3, 4]
    assert blk["b"][1] is None and blk["b"][0] == 2
    assert blk["c"][2] == 9 and blk["c"][0] is None


def test_block_concat_heterogeneous_keys_across_blocks():
    """A nullable column absent from a whole chunk must survive concat
    (union keys, None-filled) in BOTH orders."""
    b1 = {"a": np.array([1, 2])}
    b2 = {"a": np.array([3]), "b": np.array([9])}
    for blocks in ([b1, b2], [b2, b1]):
        out = block_concat(blocks)
        assert set(out) == {"a", "b"}
        assert sorted(out["a"].tolist()) == [1, 2, 3]
        assert sum(v is None for v in out["b"]) == 2


def test_rebatch_blocks_boundaries():
    blocks = [{"x": np.arange(3)}, {"x": np.arange(3, 5)},
              {"x": np.arange(5, 11)}]
    batches = list(rebatch_blocks(iter(blocks), 4))
    assert [b["x"].tolist() for b in batches] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]
    batches = list(rebatch_blocks(iter(blocks), 4, drop_last=True))
    assert len(batches) == 2


def test_block_ops():
    blk = {"x": np.arange(10)}
    assert block_num_rows(block_slice(blk, 2, 5)) == 3
    assert block_take(blk, np.array([0, 9]))["x"].tolist() == [0, 9]
    assert block_concat([blk, blk])["x"].shape == (20,)


# ------------------------------------------------- dataset (local path)
def test_range_count_take_schema():
    ds = rd.range(100, override_num_blocks=7)
    assert ds.num_partitions() == 7
    assert ds.count() == 100
    assert [r["id"] for r in ds.take(3)] == [0, 1, 2]
    assert ds.schema() == {"id": "int64"}


def test_map_filter_flat_map_chain():
    ds = (rd.range(20)
          .map(lambda r: {"id": r["id"], "sq": int(r["id"]) ** 2})
          .filter(lambda r: r["id"] % 2 == 0)
          .flat_map(lambda r: [r, r]))
    rows = ds.take_all()
    assert len(rows) == 20            # 10 evens duplicated
    assert rows[0]["sq"] == 0 and rows[2]["sq"] == 4


def test_map_batches_with_batch_size():
    """batch_size re-chunks WITHIN a partition (each read task executes
    its op chain independently — reference semantics are per-task too)."""
    def double(batch):
        assert len(batch["id"]) <= 10
        return {"id": batch["id"] * 2, "bs": np.full(len(batch["id"]),
                                                     len(batch["id"]))}

    ds = rd.range(25, override_num_blocks=2).map_batches(double,
                                                         batch_size=10)
    out = ds.take_all()
    assert len(out) == 25
    # partitions of 13/12 rows -> batches 10,3 and 10,2
    assert sorted({int(r["bs"]) for r in out}) == [2, 3, 10]
    assert out[-1]["id"] == 48


def test_iter_batches_and_shuffle_seeded():
    ds = rd.range(64, override_num_blocks=4)
    batches = list(ds.iter_batches(batch_size=16))
    assert [block_num_rows(b) for b in batches] == [16, 16, 16, 16]
    a = [r["id"] for b in rd.range(64).iter_batches(
        batch_size=64, local_shuffle_buffer_size=32, seed=5) for r in [b]]
    b_ = [r["id"] for b in rd.range(64).iter_batches(
        batch_size=64, local_shuffle_buffer_size=32, seed=5) for r in [b]]
    assert np.array_equal(a[0], b_[0])          # deterministic w/ seed
    assert not np.array_equal(a[0], np.arange(64))  # actually shuffled
    assert sorted(a[0].tolist()) == list(range(64))  # a permutation


def test_split_and_repartition():
    ds = rd.range(30, override_num_blocks=6)
    shards = ds.split(3)
    assert [s.num_partitions() for s in shards] == [2, 2, 2]
    ids = sorted(r["id"] for s in shards for r in s.take_all())
    assert ids == list(range(30))
    with pytest.raises(ValueError):
        rd.range(4, override_num_blocks=2).split(3)
    rep = rd.range(10, override_num_blocks=2).repartition(5)
    assert rep.num_partitions() == 5
    assert rep.count() == 10


def test_from_items_and_from_numpy():
    ds = rd.from_items([{"v": i} for i in range(7)], override_num_blocks=2)
    assert ds.count() == 7
    ds2 = rd.from_numpy({"x": np.arange(12), "y": np.ones(12)})
    assert ds2.count() == 12
    assert ds2.schema()["y"] == "float64"


# --------------------------------------------------------------- files
def test_jsonl_roundtrip(tmp_path):
    p = tmp_path / "in.jsonl"
    with open(p, "w") as f:
        for i in range(10):
            f.write(json.dumps({"text": f"doc{i}", "n": i}) + "\n")
    ds = rd.read_json(str(p))
    assert ds.count() == 10
    assert ds.take(1)[0]["text"] == "doc0"
    out = ds.write_jsonl(str(tmp_path / "out"))
    back = rd.read_json(out)
    assert back.count() == 10


def test_jsonl_heterogeneous_fields(tmp_path):
    p = tmp_path / "opt.jsonl"
    with open(p, "w") as f:
        f.write(json.dumps({"a": 1, "b": 2}) + "\n")
        f.write(json.dumps({"a": 3}) + "\n")
    rows = rd.read_json(str(p)).take_all()
    assert rows[1]["b"] is None


def test_parquet_roundtrip(tmp_path):
    pytest.importorskip("pyarrow")
    src = rd.from_numpy({"x": np.arange(20), "s": np.array(
        [f"r{i}" for i in range(20)], dtype=object)})
    files = src.write_parquet(str(tmp_path / "pq"))
    ds = rd.read_parquet(files)
    assert ds.count() == 20
    assert ds.take(2)[1]["s"] == "r1"
    only_x = rd.read_parquet(files, columns=["x"])
    assert set(only_x.schema()) == {"x"}


def test_csv_read(tmp_path):
    pytest.importorskip("pyarrow")
    p = tmp_path / "t.csv"
    with open(p, "w") as f:
        f.write("a,b\n1,x\n2,y\n3,z\n")
    ds = rd.read_csv(str(p))
    assert ds.count() == 3
    assert ds.take_all()[2]["b"] == "z"


# ---------------------------------------------------- torch ingestion
def test_iter_torch_batches_sharded_and_stats():
    import torch
    ds = rd.from_numpy({"tokens": np.arange(64 * 4).reshape(64, 4)})
    stats = {}
    got = list(ds.iterator().iter_torch_batches(
        batch_size=16, device="cpu", dtypes={"tokens": "int32"},
        stats=stats))
    assert len(got) == 4
    assert got[0]["tokens"].shape == (16, 4)
    assert got[0]["tokens"].dtype == torch.int32
    assert got[0]["tokens"].device.type == "cpu"
    np.testing.assert_array_equal(
        torch.cat([b["tokens"] for b in got]).numpy(),
        np.arange(64 * 4).reshape(64, 4))
    assert stats["num_batches"] == 4
    assert "input_wait_s" in stats


def test_iter_torch_batches_abandoned_consumer_no_hang():
    """Breaking out of the loop early must retire the producer threads.
    Checks by thread name, not absolute count — unrelated runtime
    threads may start concurrently during the window."""
    def data_threads():
        return [t for t in threading.enumerate()
                if t.name.startswith(("data-prefetch", "data-producer"))]
    ds = rd.from_numpy({"x": np.arange(4096)})
    it = iter(ds.iterator().iter_torch_batches(batch_size=8, device="cpu",
                                               prefetch_depth=1))
    next(it)
    it.close()                       # abandon mid-stream
    deadline = time.time() + 5
    while data_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not data_threads()


# ----------------------------------------------- remote streaming path
def test_stream_blocks_remote_execution(ray_cluster):
    calls = []

    def tag(batch):
        # runs inside a ray_tpu_torch worker: record the process
        return {"id": batch["id"], "pid": np.full(len(batch["id"]),
                                                  os.getpid())}

    ds = rd.range(40, override_num_blocks=4).map_batches(tag)
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(40))
    pids = {int(r["pid"]) for r in rows}
    assert os.getpid() not in pids   # executed remotely, not driver-side


def test_dataset_errors_propagate(ray_cluster):
    def boom(batch):
        raise RuntimeError("bad batch fn")

    with pytest.raises(Exception, match="bad batch fn"):
        rd.range(8).map_batches(boom).take_all()


# ------------------------------------------------- train integration
def test_trainer_consumes_dataset_shards(ray_cluster, tmp_path):
    """End-to-end: on-disk jsonl -> tokenize -> per-worker shards ->
    2-worker TorchTrainer reading via get_dataset_shard (the SURVEY §7
    step-7 read->map->iter_batches->train path)."""
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)

    p = tmp_path / "corpus.jsonl"
    with open(p, "w") as f:
        for i in range(64):
            f.write(json.dumps({"text": " ".join(["tok"] * 8),
                                "doc": i}) + "\n")

    def tokenize(batch):
        n = len(batch["doc"])
        return {"tokens": np.stack([np.arange(8) + d
                                    for d in batch["doc"]]),
                "doc": batch["doc"]}

    ds = rd.read_json(str(p), rows_per_block=8).map_batches(tokenize)

    def loop(config):
        from ray_tpu_torch import train as rt_train
        shard = rt_train.get_dataset_shard("train")
        seen = 0
        docs = []
        for batch in shard.iter_batches(batch_size=4):
            assert batch["tokens"].shape == (4, 8)
            seen += len(batch["doc"])
            docs.extend(int(d) for d in batch["doc"])
        rt_train.report({"seen": seen, "first_doc": docs[0]})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="data_e2e",
                             storage_path=str(tmp_path / "results")),
        backend_config=TorchConfig(distributed=False),
        datasets={"train": ds})
    result = trainer.fit()
    assert result.error is None
    # each worker saw half the corpus
    assert result.metrics["seen"] == 32


# ------------------------------------------ per-operator streaming
def test_streaming_staged_execution(ray_cluster):
    """An op with its own resources gets its own physical stage;
    results and ordering match the fused path, stats expose stages."""
    def double(b):
        return {"id": b["id"] * 2}

    def add_one(b):
        return {"id": b["id"] + 1}

    ds = (rd.range(40, override_num_blocks=4)
          .map_batches(double)                       # fuses into read
          .map_batches(add_one, num_cpus=1, concurrency=2))  # own stage
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == [2 * i + 1 for i in range(40)]
    st = ds.stats()
    assert st is not None and len(st.stages) == 2
    assert st.stages[0]["ops"] == ["map_batches"]    # read+double fused
    assert st.stages[1]["concurrency"] == 2
    assert st.stages[1]["tasks"] == 4                # one per partition
    assert st.stages[1]["blocks_out"] >= 4


def test_streaming_stage_actor_pool(ray_cluster):
    """A per-op ActorPoolStrategy scopes the pool to that stage only;
    callable-class state persists across partitions within the pool."""
    class Tagger:
        def __init__(self, base):
            self.base = base
            self.seen = 0

        def __call__(self, b):
            self.seen += 1
            return {"id": b["id"], "seen": np.full(len(b["id"]),
                                                   self.seen),
                    "base": np.full(len(b["id"]), self.base)}

    ds = (rd.range(24, override_num_blocks=6)
          .map_batches(Tagger, fn_constructor_args=(7,),
                       compute=rd.ActorPoolStrategy(2),
                       concurrency=2))
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(24))
    assert all(r["base"] == 7 for r in rows)
    # 6 partitions over a 2-actor pool: some actor saw >1 partition
    assert max(r["seen"] for r in rows) > 1
    st = ds.stats()
    assert st.stages[1]["actor_pool"] is True


def test_streaming_backpressure_bounds_inflight(ray_cluster):
    """A slow downstream stage must throttle the upstream reader: the
    upstream may run ahead only by its window + the bounded backlog."""
    import ray_tpu_torch as rt

    class TouchCounter:
        def __init__(self):
            self.n = 0

        def touch(self):
            self.n += 1

        def peak(self):
            return self.n

    counter = rt.remote(TouchCounter).remote()

    def track(b):
        rt.get(counter.touch.remote())
        return b

    def slow(b):
        time.sleep(0.15)
        return b

    ds = (rd.range(64, override_num_blocks=16)
          .map_batches(track)
          .map_batches(slow, concurrency=1))
    it = ds.iter_blocks()
    next(it)  # pull ONE output block, then stop consuming
    high = rt.get(counter.peak.remote())
    # fused read stage window (4) + backlog slack; far below 16
    assert high <= 12, high
    for _ in it:
        pass
    assert rt.get(counter.peak.remote()) == 16  # all eventually ran


def test_streaming_stage0_keeps_dataset_actor_pool(ray_cluster):
    """A dataset-level ActorPoolStrategy (attached by a spec-less
    stateful map_batches) must survive the switch to staged execution:
    stage 0 runs on a persistent pool, not one-shot tasks."""
    class Counter:
        def __init__(self):
            self.seen = 0

        def __call__(self, b):
            self.seen += 1
            return {"id": b["id"], "seen": np.full(len(b["id"]),
                                                   self.seen)}

    ds = (rd.range(24, override_num_blocks=6)
          .map_batches(Counter, compute=rd.ActorPoolStrategy(2))
          .map_batches(lambda b: b, concurrency=2))   # forces staging
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(24))
    # persistent pool => some instance saw more than one partition
    assert max(r["seen"] for r in rows) > 1
    st = ds.stats()
    assert st.stages[0]["actor_pool"] is True


def test_streaming_local_fallback_no_runtime(tmp_path):
    ds = (rd.range(10, override_num_blocks=2)
          .map_batches(lambda b: {"id": b["id"] + 1},
                       num_cpus=1, concurrency=2))
    assert sorted(r["id"] for r in ds.take_all()) == list(range(1, 11))


# ------------------------------------------------ datasource breadth
def test_read_text_and_binary(tmp_path):
    p = tmp_path / "a.txt"
    p.write_text("alpha\nbeta\ngamma\n")
    rows = rd.read_text(str(p)).take_all()
    assert [r["text"] for r in rows] == ["alpha", "beta", "gamma"]

    b = tmp_path / "blob.bin"
    b.write_bytes(b"\x00\x01binary")
    rows = rd.read_binary_files(str(b)).take_all()
    assert rows[0]["bytes"] == b"\x00\x01binary"
    assert rows[0]["path"].endswith("blob.bin")


def test_read_images(tmp_path):
    from PIL import Image
    for i, shape in enumerate([(8, 6), (10, 12)]):
        img = Image.fromarray(
            (np.arange(shape[0] * shape[1] * 3) % 255).astype(
                np.uint8).reshape(shape[0], shape[1], 3))
        img.save(tmp_path / f"im{i}.png")
    # resized: dense batched column
    rows = rd.read_images(str(tmp_path / "*.png"), size=(4, 5),
                          include_paths=True).take_all()
    assert len(rows) == 2
    assert all(r["image"].shape == (4, 5, 3) for r in rows)
    assert all(r["image"].dtype == np.uint8 for r in rows)
    assert {os.path.basename(r["path"]) for r in rows} == {"im0.png",
                                                           "im1.png"}


def test_tfrecords_roundtrip(tmp_path):
    ds1 = rd.from_items([
        {"name": "a", "score": 1.5, "count": 7,
         "vec": np.asarray([1.0, 2.0, 3.0], dtype=np.float32),
         "raw": b"\x00\xff"},
        {"name": "b", "score": -2.25, "count": -3,
         "vec": np.asarray([4.0, 5.0, 6.0], dtype=np.float32),
         "raw": b"xyz"},
    ], override_num_blocks=1)
    (out,) = ds1.write_tfrecords(str(tmp_path / "tfr"))
    rows = sorted(rd.read_tfrecords(out).take_all(),
                  key=lambda r: r["name"])
    assert [r["name"] for r in rows] == [b"a", b"b"]  # tf semantics:
    assert rows[0]["raw"] == b"\x00\xff"              # strings = bytes
    assert rows[0]["count"] == 7 and rows[1]["count"] == -3
    assert abs(rows[1]["score"] - (-2.25)) < 1e-6
    np.testing.assert_allclose(rows[0]["vec"], [1, 2, 3])


def test_tfrecord_crc_is_real_crc32c(tmp_path):
    # known-answer test: crc32c("123456789") == 0xE3069283
    from ray_tpu_torch.data.datasource import _crc32c
    assert _crc32c(b"123456789") == 0xE3069283


def test_write_csv_roundtrip(tmp_path):
    ds1 = rd.from_items([{"x": i, "y": f"s{i}"} for i in range(5)],
                        override_num_blocks=2)
    (out,) = ds1.write_csv(str(tmp_path / "csv"))
    rows = sorted(rd.read_csv(out).take_all(), key=lambda r: r["x"])
    assert [int(r["x"]) for r in rows] == list(range(5))
    assert [r["y"] for r in rows] == [f"s{i}" for i in range(5)]


def test_a_submodule_import_loads_no_other_data_module():
    """A worker's connection thread and task thread may unpickle two data
    submodules at once; when the package imported every submodule, each
    thread held one submodule's import lock and waited for the package
    the other was running, and one got a half-imported module (ROADMAP
    queue 3, item 10). The package now resolves its names at first use,
    so importing a submodule imports only what it needs."""
    import subprocess
    import sys
    code = ("import sys, ray_tpu_torch.data.datasource\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.startswith('ray_tpu_torch.data')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "['ray_tpu_torch.data',", "'ray_tpu_torch.data.block',",
        "'ray_tpu_torch.data.datasource']"]
    assert rd.from_numpy is rd.dataset.from_numpy
