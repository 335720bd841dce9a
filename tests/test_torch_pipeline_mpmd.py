"""MPMD pipeline parallelism (r13): channel rings, the wire transport,
stage-death propagation, and stage-per-worker-group training parity.

The twin of `tests/test_pipeline_mpmd.py`, test for test, on the port
(`ray_tpu_torch.experimental`, `ray_tpu_torch.train.pipeline`,
`TorchTrainer(pipeline_stages=...)`), with its four `slow` marks. The
training cases run a small tanh MLP over stacked layer weights, written
once in each package; the fast parity case trains it through the port's
`_stage_loop` and the JAX `_stage_loop`, both in threads over shm
channels, for both schedules. Also here: torch tensors through both
channel transports, bit for bit.

The heavy 4-stage wire e2e (parity + Perfetto overlap assertion) is
@slow; every feature keeps a fast tier-1 sibling here.
"""
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


# ------------------------------------------------------ ring buffers
def test_channel_ring_depth_buffers_writes():
    """depth=2 double-buffers: two publishes complete without any
    reader progress; the third blocks until a slot frees (the property
    transfer/compute overlap rests on). depth=1 keeps the old
    single-slot semantics."""
    from ray_tpu_torch.experimental.channel import Channel, ChannelClosed, \
        ChannelTimeout
    ch = Channel.create(capacity=1 << 14, n_readers=1, depth=2)
    w, r = ch.writer(), ch.reader(0)
    w.write(b"m1")
    w.write(b"m2")                      # second slot: no reader needed
    with pytest.raises(ChannelTimeout):
        w.write(b"m3", timeout=0.2)     # ring full
    assert r.read() == b"m1"
    w.write(b"m3", timeout=5.0)         # slot freed by the read
    assert r.read() == b"m2" and r.read() == b"m3"
    arr = np.arange(64, dtype=np.float32)
    w.write(arr)                        # raw frames ride ring slots too
    assert np.array_equal(r.read(), arr)
    w.close()
    with pytest.raises(ChannelClosed):
        r.read(timeout=5.0)
    ch.destroy()

    ch1 = Channel.create(capacity=1 << 12, n_readers=1, depth=1)
    w1, r1 = ch1.writer(), ch1.reader(0)
    w1.write("a")
    with pytest.raises(ChannelTimeout):
        w1.write("b", timeout=0.2)      # single slot: writer gated
    assert r1.read() == "a"
    ch1.destroy()


def test_channel_ring_close_drains_buffered_messages():
    """The closed marker lands in its own ring slot: messages already
    published drain before readers see ChannelClosed."""
    from ray_tpu_torch.experimental.channel import Channel, ChannelClosed
    ch = Channel.create(capacity=1 << 12, n_readers=1, depth=3)
    w, r = ch.writer(), ch.reader(0)
    w.write(1)
    w.write(2)
    w.close()
    assert r.read() == 1 and r.read() == 2
    with pytest.raises(ChannelClosed):
        r.read(timeout=5.0)
    ch.destroy()


# ---------------------------------------------------- wire transport
def test_wire_channel_roundtrip_ring_and_close():
    from ray_tpu_torch.experimental.channel import (ChannelClosed,
                                                    ChannelTimeout)
    from ray_tpu_torch.experimental.wire_channel import (CH_STATS,
                                                         serve_channel)
    ch = serve_channel(capacity=1 << 20, n_readers=1, depth=2,
                       label="t0")
    r = ch.reader(0)
    w = ch.writer()
    raw0 = CH_STATS["tx_raw"]
    arr = np.arange(256, dtype=np.int64)
    w.write(arr)                        # ndarray -> Envelope raw field
    got = r.read(timeout=10.0)
    assert np.array_equal(got, arr)
    assert CH_STATS["tx_raw"] == raw0 + 1
    w.write({"k": [1, 2]})              # non-array -> pickled body
    assert r.read(timeout=10.0) == {"k": [1, 2]}
    # ring flow control over the wire: depth unacked messages max
    w.write(b"a")
    w.write(b"b")
    with pytest.raises(ChannelTimeout):
        w.write(b"c", timeout=0.2)
    assert r.read(timeout=10.0) == b"a"
    w.write(b"c", timeout=10.0)
    assert r.read(10.0) == b"b" and r.read(10.0) == b"c"
    w.close()
    with pytest.raises(ChannelClosed):
        r.read(timeout=10.0)
    r.release()
    ch.destroy()


def test_wire_channel_old_peer_falls_back_to_pickled_body():
    """MINOR negotiation: toward a peer that demonstrated a pre-r13
    wire version, CH_DATA payloads ship in the pickled body instead of
    the Envelope raw field — same values, old peers unaffected."""
    from ray_tpu_torch.experimental import wire_channel as wc
    ch = wc.serve_channel(capacity=1 << 20, n_readers=1, depth=2,
                          label="old")
    r = ch.reader(0)
    w = ch.writer()
    srv = wc._SERVERS[ch.name]
    with srv._cv:                       # simulate an old (MINOR 4) peer
        for conn in srv._conns.values():
            conn.peer_wire_version = 104
    blob0, raw0 = wc.CH_STATS["tx_blob"], wc.CH_STATS["tx_raw"]
    arr = np.arange(64, dtype=np.float32)
    w.write(arr)
    got = r.read(timeout=10.0)
    assert np.array_equal(got, arr)
    assert wc.CH_STATS["tx_blob"] == blob0 + 1
    assert wc.CH_STATS["tx_raw"] == raw0
    w.close()
    r.release()
    ch.destroy()


# ------------------------------------------------------ tracing gate
def test_channel_spans_recorded_and_zero_when_disabled():
    """Channel write/wait/read land tracing-plane spans when a trace
    is active; with RAY_TPU_TRACE=0 nothing is recorded (the hot-path
    zero-cost discipline)."""
    from ray_tpu_torch._private import tracing_plane as tp
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch.experimental.channel import Channel
    prev = os.environ.get("RAY_TPU_TRACE")
    try:
        os.environ["RAY_TPU_TRACE"] = "1"
        CONFIG.reload()
        rec = tp.recorder()
        base = rec.watermark()
        tp.set_current(tp.new_id(), 0)
        ch = Channel.create(capacity=1 << 12, n_readers=1, depth=2)
        w, r = ch.writer(), ch.reader(0)
        w.write(b"x")
        assert r.read() == b"x"
        ch.destroy()
        tp.clear_current()
        assert tp.recorder().watermark() > base
        names = {e[4] for e in tp.recorder().snapshot()
                 if e[3] == "channel"}
        assert any(n.startswith("ch.write:") for n in names), names
        assert any(n.startswith("ch.read:") for n in names), names

        os.environ["RAY_TPU_TRACE"] = "0"
        CONFIG.reload()
        tp.set_current(tp.new_id(), 0)
        ch2 = Channel.create(capacity=1 << 12, n_readers=1, depth=2)
        w2, r2 = ch2.writer(), ch2.reader(0)
        w2.write(b"y")
        assert r2.read() == b"y"
        ch2.destroy()
        assert tp.recorder().watermark() == 0   # zero records
    finally:
        if prev is None:
            os.environ.pop("RAY_TPU_TRACE", None)
        else:
            os.environ["RAY_TPU_TRACE"] = prev
        CONFIG.reload()
        tp.clear_current()


def test_annotate_lands_in_recorder_and_profile_writes_a_trace(tmp_path):
    """`util.tracing` on the port: `annotate` and `annotate_fn` spans land
    in this process's flight recorder (the stage timeline's source, as
    `tests/test_tracing_plane.py::test_annotate_lands_in_recorder` holds
    for the JAX module), and `profile` writes a `torch.profiler` Chrome
    trace."""
    from ray_tpu_torch._private import tracing_plane as tp
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch.util import tracing
    prev = os.environ.get("RAY_TPU_TRACE")
    os.environ["RAY_TPU_TRACE"] = "1"
    CONFIG.reload()
    try:
        rec = tp.recorder()
        base = rec.watermark()
        with tracing.annotate("my_phase"):
            pass

        @tracing.annotate_fn("my_fn")
        def work(x):
            return x + 1
        assert work(1) == 2
        evs = [e for e in rec.snapshot() if e[4] in ("my_phase", "my_fn")]
        assert [e[4] for e in evs[-2:]] == ["my_phase", "my_fn"]
        assert all(e[3] == "user" for e in evs)
        assert rec.watermark() == base + 2
        with tracing.profile(str(tmp_path)):
            torch.ones(4).sum()
        assert any(f.name.startswith("trace_") for f in tmp_path.iterdir())
    finally:
        if prev is None:
            os.environ.pop("RAY_TPU_TRACE", None)
        else:
            os.environ["RAY_TPU_TRACE"] = prev
        CONFIG.reload()


# ----------------------------------------------- uneven layer splits
def test_partition_layers_remainder_to_last_stage():
    from ray_tpu_torch.parallel.pipeline import partition_layers, slice_stage
    assert partition_layers(8, 4) == [(0, 2), (2, 2), (4, 2), (6, 2)]
    assert partition_layers(7, 3) == [(0, 2), (2, 2), (4, 3)]
    assert partition_layers(5, 2) == [(0, 2), (2, 3)]
    with pytest.raises(ValueError, match="cannot fill"):
        partition_layers(2, 3)
    sl = slice_stage({"w": torch.zeros((7, 3))}, 4, 3)
    assert sl["w"].shape == (3, 3)
    # the port's layout, a list of per-layer trees, slices the same way
    assert len(slice_stage([{"w": i} for i in range(7)], 4, 3)) == 3
    # split_stages still rejects uneven whole-stack mode with guidance
    from ray_tpu_torch.parallel.pipeline import split_stages
    with pytest.raises(ValueError, match="not divisible"):
        split_stages({"w": torch.zeros((7, 3))}, 2)


@pytest.mark.slow        # ~19s compile-bound parity in the JAX twin
def test_spmd_pipeline_uneven_layer_fn_parity():
    """pipeline_apply/pipeline_grads_1f1b accept L % S != 0 via the
    per-layer path: outputs, loss AND grads match the sequential stack
    (remainder layers on the last stage). The port runs each stage on
    its own gloo rank (3 ranks); `tests/test_torch_pipeline.py` holds the
    same path to the JAX functions in tier-1."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from torch_ranks import RankPool
    pool = RankPool(3)
    try:
        outs = pool.run(3, _uneven_parity_on_a_rank)
    finally:
        pool.close()
    for out_err, loss_err, grad_err in outs:
        assert out_err < 1e-5 and loss_err < 1e-5 and grad_err < 1e-4


def _uneven_parity_on_a_rank():
    from ray_tpu_torch.parallel import MeshSpec, prepare_mesh
    from ray_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                 pipeline_grads_1f1b)
    L, D, B, S, M = 7, 8, 12, 3, 4
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(L, D, D, generator=g) * 0.2,
              "b": torch.zeros(L, D)}
    x = torch.randn(B, D, generator=g)
    targets = torch.randn(B, D, generator=g)

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    def seq_apply(p, h):
        for i in range(L):
            h = layer_fn({"w": p["w"][i], "b": p["b"][i]}, h)
        return h

    mesh = prepare_mesh(MeshSpec(pp=S), device="cpu")
    out = pipeline_apply(mesh, None, params, x, M, layer_fn=layer_fn)
    out_err = float((out - seq_apply(params, x)).abs().max())
    ref = {k: v.clone().requires_grad_() for k, v in params.items()}
    gt_loss = ((seq_apply(ref, x) - targets) ** 2).sum() / M
    gt_loss.backward()
    loss, grads = pipeline_grads_1f1b(
        mesh, None, lambda y, t: ((y - t) ** 2).sum(), params, x, targets,
        M, layer_fn=layer_fn)
    grad_err = max(float(((grads[k] - ref[k].grad).abs()
                          / (ref[k].grad.abs() + 1e-6)).max())
                   for k in ("w", "b"))
    return (out_err, abs(float(loss) - float(gt_loss))
            / abs(float(gt_loss)), grad_err)


# --------------------------------------------- stage-death propagation
@pytest.mark.parametrize("transport", ["shm", "wire"])
def test_dag_stage_death_surfaces_and_leaves_no_segments(
        ray_cluster, transport):
    """A stage actor killed mid-pipeline: the error surfaces at
    execute()/get() within seconds (no hang), surviving loops unwedge
    via the abort flag, and teardown leaves no channel shm segments —
    on both transports."""
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class Stage:
        def work(self, x):
            time.sleep(0.05)
            return x + 1

    a, b, c = Stage.remote(), Stage.remote(), Stage.remote()
    with InputNode() as inp:
        out = c.work.bind(b.work.bind(a.work.bind(inp)))
    dag = out.experimental_compile(enable_shm_channels=True,
                                   channel_transport=transport)
    try:
        assert dag.execute(1).get(timeout=60) == 4
        ray_tpu_torch.kill(b)                     # middle stage dies
        t0 = time.time()
        with pytest.raises((RuntimeError, Exception)) as ei:
            dag.execute(10).get(timeout=60)
        assert time.time() - t0 < 40        # surfaced, not hung
        assert "died mid-pipeline" in str(ei.value) or \
            "ChannelClosed" in type(ei.value).__name__
        names = {ch.name for ch in dag._channels.values()}
    finally:
        dag.teardown()
    leaked = [n for n in os.listdir("/dev/shm") if n in names]
    assert not leaked, leaked
    for act in (a, c):
        try:
            ray_tpu_torch.kill(act)
        except Exception:
            pass



# ------------------------------------------------ MPMD training parity
def _mlp_fixture(L, D, steps, B, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.normal(size=(L, D, D)) * 0.2).astype(np.float32),
              "b": np.zeros((L, D), np.float32)}
    X = rng.normal(size=(steps, B, D)).astype(np.float32)
    T = rng.normal(size=(steps, B, D)).astype(np.float32)
    return params, X, T


def _mlp_fns():
    """The port's stage (the tanh layers of a stacked sub-stack) and
    loss; made in a function, so cloudpickle sends them to the stage
    workers by value (the workers cannot import this module)."""
    def stage_fn(p, h):
        import torch
        for i in range(p["w"].shape[0]):
            h = torch.tanh(h @ p["w"][i] + p["b"][i])
        return h

    def loss_fn(y, t):
        return ((y - t) ** 2).sum()
    return stage_fn, loss_fn


stage_fn, loss_fn = _mlp_fns()


def _jax_stage_fn(p, h):
    import jax
    import jax.numpy as jnp

    def layer(h, wb):
        w, b = wb
        return jnp.tanh(h @ w + b), None
    h, _ = jax.lax.scan(layer, h, (p["w"], p["b"]))
    return h


def _jax_loss_fn(y, t):
    import jax.numpy as jnp
    return jnp.sum((y - t) ** 2)


def _sequential_sgd(params, X, T, M, lr):
    """Reference trajectory: full-stack microbatch-mean loss + SGD, in
    torch on the CPU."""
    losses = []
    p = {k: torch.tensor(v) for k, v in params.items()}
    for step in range(X.shape[0]):
        x, t = torch.tensor(X[step]), torch.tensor(T[step])
        bs = x.shape[0] // M
        q = {k: v.clone().requires_grad_() for k, v in p.items()}
        tot = 0.0
        for m in range(M):
            y = stage_fn(q, x[m * bs:(m + 1) * bs])
            tot = tot + loss_fn(y, t[m * bs:(m + 1) * bs])
        loss = tot / M
        loss.backward()
        losses.append(float(loss))
        p = {k: (v - lr * q[k].grad).detach() for k, v in p.items()}
    return losses, p


def _run_in_threads(stage_loop, params, X, T, M, lr, schedule, make_ch,
                    stage_fns, extra=()):
    """Train 2 stages in two THREADS of this process over shm ring
    channels (no actor spawns — the schedule/channel logic is identical
    to the actor deployment); returns (losses, per-stage final params)."""
    import threading

    from ray_tpu_torch.parallel.pipeline import partition_layers
    S, STEPS, B = 2, X.shape[0], X.shape[1]
    data_ch, tgt_ch, act0, grad0, loss_ch = (
        make_ch("data"), make_ch("tgt"), make_ch("act0"), make_ch("grad0"),
        make_ch("loss"))
    parts = partition_layers(params["w"].shape[0], S)
    out: dict = {}

    def run_stage(s):
        start, count = parts[s]
        args = [None, s, S, {k: v[start:start + count]
                             for k, v in params.items()},
                stage_fns[0], stage_fns[1], (), schedule, M, STEPS,
                data_ch if s == 0 else act0,          # in
                tgt_ch if s == 1 else None,           # targets
                act0 if s == 0 else None,             # act out
                grad0 if s == 0 else None,            # cot in
                grad0 if s == 1 else None,            # cot out
                loss_ch if s == 1 else None,
                None, None, lr, 0, *extra]
        try:
            out[s] = stage_loop(*args)
        except BaseException as e:  # noqa: BLE001
            out[s] = e

    threads = [threading.Thread(target=run_stage, args=(s,), daemon=True)
               for s in range(S)]
    for t in threads:
        t.start()
    data_w, tgt_w, loss_r = data_ch.writer(), tgt_ch.writer(), \
        loss_ch.reader(0)
    got = []
    bs = B // M
    try:
        for step in range(STEPS):
            for m in range(M):
                data_w.write(np.ascontiguousarray(
                    X[step][m * bs:(m + 1) * bs]), timeout=60.0)
                tgt_w.write(np.ascontiguousarray(
                    T[step][m * bs:(m + 1) * bs]), timeout=60.0)
            got.append(loss_r.read(timeout=60.0)["loss"])
        for t in threads:
            t.join(timeout=60)
    finally:
        for ch in (data_ch, tgt_ch, act0, grad0, loss_ch):
            ch.destroy()
    for s in range(S):
        assert not isinstance(out.get(s), BaseException), out[s]
    return got, [out[s] for s in range(S)]


def _port_in_threads(params, X, T, M, lr, schedule):
    from ray_tpu_torch.experimental.channel import Channel
    from ray_tpu_torch.train.pipeline import _stage_loop

    def mk(label):
        return Channel.create(capacity=1 << 20, n_readers=1, depth=2,
                              label=label)
    losses, stages = _run_in_threads(_stage_loop, params, X, T, M, lr,
                                     schedule, mk, (stage_fn, loss_fn),
                                     extra=("cpu",))
    return losses, {k: torch.cat([s[k] for s in stages]).numpy()
                    for k in ("w", "b")}


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_mpmd_stage_loop_matches_the_jax_stage_loop_in_threads(schedule):
    """The same tanh MLP (4 layers, two stages of 2) trained 3 steps by
    the port's `_stage_loop` and by the JAX `_stage_loop`, each pair of
    stages in two threads over its package's shm ring channels, from the
    same numpy weights and batches: losses 1e-5 relative, final params
    1e-5 absolute / 1e-4 relative (f32)."""
    import jax.numpy as jnp

    from ray_tpu.experimental.channel import Channel as JChannel
    from ray_tpu.train.pipeline import _stage_loop as j_stage_loop
    L, D, B, M, STEPS, LR = 4, 8, 8, 4, 3, 1e-2
    params, X, T = _mlp_fixture(L, D, STEPS, B, seed=3)
    losses, final = _port_in_threads(params, X, T, M, LR, schedule)

    def jmk(label):
        return JChannel.create(capacity=1 << 20, n_readers=1, depth=2,
                               label=label)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    j_losses, j_stages = _run_in_threads(
        j_stage_loop, jparams, X, T, M, LR, schedule, jmk,
        (_jax_stage_fn, _jax_loss_fn))
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for k in ("w", "b"):
        j_full = np.concatenate([np.asarray(s[k]) for s in j_stages])
        np.testing.assert_allclose(final[k], j_full, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    ref_losses, _ = _sequential_sgd(params, X, T, M, LR)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)


@pytest.mark.slow        # ~29s in the JAX twin; the dag-stage-death and
                         # channel tests keep MPMD wiring in tier-1
def test_mpmd_pipeline_2stage_1f1b_parity(ray_cluster):
    """TorchTrainer pipeline_stages=2 over shm channels, on CPU workers,
    matches the sequential full-stack trajectory and the in-thread run
    of the same stage loops — losses AND final params (uneven 5-layer
    split: stage 0 gets 2 layers, stage 1 gets 3)."""
    from ray_tpu_torch.train import PipelineConfig, TorchTrainer
    L, D, B, M, STEPS, LR = 5, 8, 8, 4, 2, 1e-2
    params, X, T = _mlp_fixture(L, D, STEPS, B)
    trainer = TorchTrainer(
        pipeline_stages=2,
        pipeline_config=PipelineConfig(
            init_params={k: torch.tensor(v) for k, v in params.items()},
            stage_fn=stage_fn, loss_fn=loss_fn,
            batch_fn=lambda s: (X[s], T[s]), steps=STEPS,
            num_microbatches=M, schedule="1f1b", transport="shm",
            channel_capacity_bytes=1 << 20, lr=LR))
    res = trainer.fit()
    assert res.error is None, res.error
    ref_losses, ref_params = _sequential_sgd(params, X, T, M, LR)
    got = [h["loss"] for h in res.metrics_history]
    assert len(got) == STEPS
    for a, b in zip(got, ref_losses):
        assert abs(a - b) < 1e-3 * max(1.0, abs(b)), (got, ref_losses)
    thread_losses, thread_params = _port_in_threads(params, X, T, M, LR,
                                                    "1f1b")
    np.testing.assert_allclose(got, thread_losses, rtol=1e-6)
    final = res.artifacts["params"]
    for k in ("w", "b"):
        np.testing.assert_allclose(final[k].numpy(),
                                   ref_params[k].numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(final[k].numpy(), thread_params[k],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.slow        # ~21s schedule parity sweep
def test_mpmd_gpipe_schedule_parity_in_threads():
    """GPipe fallback schedule, hermetic: the stage loops run in two
    THREADS of this process over shm ring channels (no actor spawns —
    the schedule/channel logic is identical to the actor deployment),
    and the trajectory matches the sequential reference."""
    L, D, B, M, STEPS, LR = 4, 8, 8, 4, 2, 1e-2
    params, X, T = _mlp_fixture(L, D, STEPS, B, seed=3)
    got, final = _port_in_threads(params, X, T, M, LR, "gpipe")
    ref_losses, ref_params = _sequential_sgd(params, X, T, M, LR)
    for a, b in zip(got, ref_losses):
        assert abs(a - b) < 1e-3 * max(1.0, abs(b)), (got, ref_losses)
    np.testing.assert_allclose(final["w"], ref_params["w"].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_mpmd_4stage_wire_parity_and_overlap(ray_cluster):
    """The r13 acceptance e2e: a 4-stage multi-process pipeline over
    WIRE channels matches the sequential trajectory (the JAX twin holds
    it to the single-process pp-axis 1F1B, which
    `tests/test_torch_pipeline.py` holds to direct autodiff), and the
    collected cross-process timeline shows stage transfer spans
    CONCURRENT with neighbor stages' compute spans, with a finite bubble
    fraction reported."""
    from ray_tpu_torch.train import PipelineConfig, TorchTrainer
    from ray_tpu_torch.train.pipeline import bubble_fraction, overlap_pairs
    L, D, B, S, M, STEPS, LR = 8, 64, 16, 4, 8, 3, 1e-2
    params, X, T = _mlp_fixture(L, D, STEPS, B, seed=1)
    trainer = TorchTrainer(
        pipeline_stages=S,
        pipeline_config=PipelineConfig(
            init_params={k: torch.tensor(v) for k, v in params.items()},
            stage_fn=stage_fn, loss_fn=loss_fn,
            batch_fn=lambda s: (X[s], T[s]), steps=STEPS,
            num_microbatches=M, schedule="1f1b", transport="wire",
            channel_capacity_bytes=1 << 20, lr=LR))
    res = trainer.fit()
    assert res.error is None, res.error
    ref_losses, _ = _sequential_sgd(params, X, T, M, LR)
    got = [h["loss"] for h in res.metrics_history]
    for a, b in zip(got, ref_losses):
        assert abs(a - b) < 1e-3 * max(1.0, abs(b)), (got, ref_losses)

    procs = res.artifacts["trace_processes"]
    assert overlap_pairs(procs) > 0, \
        "no transfer/compute overlap in the stage timeline"
    bf = res.metrics.get("bubble_fraction", bubble_fraction(procs))
    assert 0.0 <= bf < 1.0
    # the timeline renders end-to-end (Perfetto JSON)
    from ray_tpu_torch._private.tracing_plane import chrome_trace
    events = chrome_trace(procs)
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert any(n.startswith("fwd:s") for n in names)
    assert any(n.startswith("ch.") for n in names)


# ------------------------------------------- tensors through channels
def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _channels():
    from ray_tpu_torch.experimental.channel import Channel
    from ray_tpu_torch.experimental.wire_channel import serve_channel
    shm = Channel.create(capacity=1 << 16, n_readers=1, depth=2)
    wire = serve_channel(capacity=1 << 16, n_readers=1, depth=2)
    return [shm, wire]


@pytest.mark.parametrize("transport", ["shm", "wire"])
def test_tensors_round_trip_bit_for_bit(transport):
    """A bf16 and an f32 CPU tensor (and a 0-d and an empty one) cross
    each transport as raw frames and come back as tensors of the same
    dtype, shape and bits; a non-contiguous view goes as its values."""
    chans = _channels()
    ch = chans[0] if transport == "shm" else chans[1]
    try:
        r = ch.reader(0)
        w = ch.writer()
        g = torch.Generator().manual_seed(0)
        sent = [torch.randn(3, 5, 7, generator=g).to(torch.bfloat16),
                torch.randn(64, 33, generator=g),
                torch.tensor(2.5, dtype=torch.bfloat16),
                torch.zeros(0, 4),
                torch.arange(12, dtype=torch.int64).reshape(3, 4).T]
        for t in sent:
            w.write(t, timeout=10.0)
            got = r.read(timeout=10.0)
            assert isinstance(got, torch.Tensor)
            assert got.dtype == t.dtype and got.shape == t.shape
            assert torch.equal(_bits(got), _bits(t))
        w.close()
    finally:
        for c in chans:
            c.destroy()


def test_a_tensor_read_on_the_cpu_owns_its_bytes():
    """The shm reader acks a slot once it has the value; a CPU tensor it
    returned must not change when the writer then reuses that slot."""
    from ray_tpu_torch.experimental.channel import Channel
    ch = Channel.create(capacity=1 << 14, n_readers=1, depth=1)
    try:
        w, r = ch.writer(), ch.reader(0)
        first = torch.full((256,), 1.0, dtype=torch.bfloat16)
        w.write(first)
        got = r.read(timeout=5.0)
        w.write(torch.full((256,), 7.0, dtype=torch.bfloat16), timeout=5.0)
        assert torch.equal(got, first)          # the slot was reused
        assert float(r.read(timeout=5.0)[0]) == 7.0
    finally:
        ch.destroy()


def test_a_tensor_a_raw_frame_cannot_carry_is_refused():
    """A sparse tensor raises at the writer: no tensor falls back to a
    pickle stream."""
    from ray_tpu_torch.experimental.channel import Channel
    ch = Channel.create(capacity=1 << 14, n_readers=1, depth=1)
    try:
        with pytest.raises(TypeError, match="dense tensors"):
            ch.writer().write(torch.eye(4).to_sparse())
    finally:
        ch.destroy()
