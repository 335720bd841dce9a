"""The twin of `tests/test_object_manifest.py`, test for test, run on
the port's object plane (`ray_tpu_torch/_private/{object_store,
object_transfer,object_directory,pull_manager}.py`); its segments are
the port's `rtt_` ones.

r12 streaming data plane: manifest transfers, cut-through relay.

Done-criteria exercised here (all over REAL TCP connections):
- manifest pulls land byte-identical objects with ZERO serve-side
  copies and exactly one land-side copy per byte (the wire->shm one)
- a MINOR<5 peer interoperates in both directions via the blob
  protocol, byte-identically
- cut-through: a child pulls landed chunk ranges from a PARTIAL
  holder whose own pull is still in flight; not-yet-landed ranges
  park event-driven and answer on landing
- mid-cut-through failure: the partial holder's own pull dies -> its
  parked children get dropped-chunk answers and re-root on the source
  (byte equality preserved)
- directory partial-holder consistency across promotion, retraction
  and node death
"""
import socket
import threading
import time

import numpy as np
import pytest

from ray_tpu_torch._private import object_store as osm
from ray_tpu_torch._private import object_transfer as ot
from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.object_directory import ObjectDirectory
from ray_tpu_torch._private.object_transfer import (OBJECT_PLANE_STATS,
                                              PullServer, landing_table,
                                              pull_object)
from ray_tpu_torch._private.pull_manager import PullManager


class _Endpoint:
    """A PullServer wired to real TCP connection pairs."""

    def __init__(self, store):
        self.store = store
        self.server = PullServer(store)
        self._lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lst.bind(("127.0.0.1", 0))
        self._lst.listen(8)
        self.addr = self._lst.getsockname()
        self._conns = []

    def _handle(self, conn, msg):
        if msg["type"] == protocol.PULL_OBJECT:
            self.server.handle_pull(conn, msg)
        elif msg["type"] == protocol.PULL_CHUNK:
            self.server.handle_chunk(conn, msg)

    def connect(self):
        cli = protocol.connect(self.addr, lambda c, m: None,
                               name="puller")
        srv_sock, _ = self._lst.accept()
        srv = protocol.Connection(
            srv_sock, self._handle,
            on_close=self.server.on_conn_closed, name="holder",
            server=True)
        srv.start()
        self._conns.append((cli, srv))
        return cli

    def close(self):
        for cli, srv in self._conns:
            cli.close()
            srv.close()
        self._lst.close()


def _snap():
    return dict(OBJECT_PLANE_STATS)


def _delta(s0, key):
    return OBJECT_PLANE_STATS[key] - s0[key]


def _wait_for(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


# ----------------------------------------------------- manifest path
def test_manifest_pull_zero_copy_roundtrip():
    """Manifest transfer: byte equality, zero serve-side copies,
    exactly one land-side copy per transferred byte, landing gone
    afterwards, pulled copy shm-backed like the source."""
    payload = np.arange(1_500_000, dtype=np.float64)     # 12 MB, 3 chunks
    src = osm.LocalStore()
    obj = osm.serialize(payload)
    src.put_stored(obj)
    oid = obj.object_id
    ep = _Endpoint(src)
    conn = ep.connect()
    dst = osm.LocalStore()
    s0 = _snap()
    stored = pull_object(conn, oid, timeout=30, store=dst)
    assert stored is not None
    assert _delta(s0, "manifest_pulls") == 1
    assert _delta(s0, "blob_pulls") == 0
    assert _delta(s0, "serve_bytes_copied") == 0, \
        "manifest serving must not copy"
    assert _delta(s0, "land_bytes_copied") == _delta(s0, "serve_bytes")
    # sealed into dst by the land path itself
    assert dst.get_stored(oid, timeout=0) is stored
    assert landing_table(dst).get(oid) is None
    assert stored.shm_names, "large buffer must land in shm"
    np.testing.assert_array_equal(osm.deserialize(stored), payload)
    dst.shutdown()
    src.shutdown()
    ep.close()


def test_manifest_mixed_buffers_and_small_object():
    """Multiple out-of-band buffers (small inline + large shm) and a
    chunk grid that straddles buffer boundaries all land
    byte-identically; tiny objects (single chunk) work too."""
    value = {"big": np.arange(700_000, dtype=np.float64),    # 5.6 MB shm
             "small": np.arange(64, dtype=np.int32),         # inline
             "big2": np.ones(650_000, dtype=np.float64),     # 5.2 MB shm
             "s": "meta"}
    src = osm.LocalStore()
    obj = osm.serialize(value)
    src.put_stored(obj)
    assert obj.buffer_order.count("s") == 2
    ep = _Endpoint(src)
    conn = ep.connect()
    dst = osm.LocalStore()
    stored = pull_object(conn, obj.object_id, timeout=30, store=dst)
    got = osm.deserialize(stored)
    np.testing.assert_array_equal(got["big"], value["big"])
    np.testing.assert_array_equal(got["big2"], value["big2"])
    np.testing.assert_array_equal(got["small"], value["small"])
    assert got["s"] == "meta"
    assert list(stored.buffer_order) == list(obj.buffer_order)

    tiny = osm.serialize([1, 2, 3])
    src.put_stored(tiny)
    st2 = pull_object(conn, tiny.object_id, timeout=30, store=dst)
    assert osm.deserialize(st2) == [1, 2, 3]
    dst.shutdown()
    src.shutdown()
    ep.close()


def test_manifest_chunk_drop_resumes():
    """A dropped manifest session re-opens and resumes at the failed
    index on the same landing (no re-landing of chunk 0)."""
    payload = np.zeros(1_500_000, dtype=np.float64)          # 3 chunks
    src = osm.LocalStore()
    obj = osm.serialize(payload)
    src.put_stored(obj)
    oid = obj.object_id
    ep = _Endpoint(src)
    conn = ep.connect()
    dropped = {"n": 0}
    real = ep.server.handle_chunk

    def dropping(c, msg):
        if msg["index"] == 1 and dropped["n"] == 0:
            dropped["n"] += 1
            with ep.server._slock:
                ep.server._drop_session_locked(msg["pull_id"])
        real(c, msg)

    ep.server.handle_chunk = dropping
    dst = osm.LocalStore()
    s0 = _snap()
    stored = pull_object(conn, oid, timeout=30, store=dst)
    assert stored is not None and dropped["n"] == 1
    assert _delta(s0, "chunk_retries") == 1
    np.testing.assert_array_equal(osm.deserialize(stored), payload)
    dst.shutdown()
    src.shutdown()
    ep.close()


# ------------------------------------------------ old-peer interop
def test_blob_interop_old_puller():
    """A MINOR<5 puller never asks for a manifest; the new holder
    serves the classic blob protocol byte-identically over a real
    connection."""
    payload = np.arange(900_000, dtype=np.float64)
    src = osm.LocalStore()
    obj = osm.serialize(payload)
    src.put_stored(obj)
    ep = _Endpoint(src)
    conn = ep.connect()
    s0 = _snap()
    # an old puller's request: no manifest key (pull_object without a
    # store sends exactly that shape)
    stored = pull_object(conn, obj.object_id, timeout=30)
    assert _delta(s0, "blob_pulls") == 1
    assert _delta(s0, "manifest_pulls") == 0
    np.testing.assert_array_equal(osm.deserialize(stored), payload)
    src.shutdown()
    ep.close()


def test_blob_interop_old_holder():
    """A MINOR<5 holder's handler never sees a `manifest` request key
    (emulated by stripping it, exactly what the old structural decode
    + handler pair amounts to): the new puller transparently degrades
    to the blob protocol and the bytes still match."""
    payload = np.arange(900_000, dtype=np.float64)
    src = osm.LocalStore()
    obj = osm.serialize(payload)
    src.put_stored(obj)
    ep = _Endpoint(src)
    real = ep.server.handle_pull

    def old_handle_pull(c, msg):
        msg.pop("manifest", None)       # an old peer ignores the key
        real(c, msg)

    ep.server.handle_pull = old_handle_pull
    conn = ep.connect()
    dst = osm.LocalStore()
    s0 = _snap()
    stored = pull_object(conn, obj.object_id, timeout=30, store=dst)
    assert stored is not None
    assert _delta(s0, "blob_pulls") == 1, \
        "manifest request against an old holder must fall back to blob"
    np.testing.assert_array_equal(osm.deserialize(stored), payload)
    dst.shutdown()
    src.shutdown()
    ep.close()


# -------------------------------------------------- cut-through relay
def _throttled_source(src_store, gate_indexes):
    """Endpoint over `src_store` whose chunk serving blocks on the
    per-index events in `gate_indexes` (missing index = no gate)."""
    ep = _Endpoint(src_store)
    real = ep.server.handle_chunk

    def gated(c, msg):
        ev = gate_indexes.get(msg["index"])
        if ev is not None:
            ev.wait(15)
        real(c, msg)

    ep.server.handle_chunk = gated
    return ep


def test_cut_through_child_served_from_partial_holder():
    """While B's own pull (from A) is stalled at chunk 1, a child C
    pulling from B gets chunk 0 from B's landing immediately, parks
    on chunk 1 (event-driven), and completes the moment B's landing
    finishes — B served C while B itself was still mid-pull."""
    payload = np.arange(1_500_000, dtype=np.float64)         # 3 chunks
    store_a = osm.LocalStore()
    obj = osm.serialize(payload)
    store_a.put_stored(obj)
    oid = obj.object_id
    gate1 = threading.Event()
    ep_a = _throttled_source(store_a, {1: gate1})

    store_b = osm.LocalStore()
    ep_b = _Endpoint(store_b)
    conn_ab = ep_a.connect()

    b_result = {}

    def b_pull():
        b_result["stored"] = pull_object(conn_ab, oid, timeout=30,
                                         store=store_b)

    tb = threading.Thread(target=b_pull)
    tb.start()
    # B's landing exists and has chunk 0 (chunk 1 gated at A)
    _wait_for(lambda: (landing_table(store_b).get(oid) is not None
                       and landing_table(store_b).get(oid).n_landed >= 1),
              msg="B's first chunk to land")

    conn_cb = ep_b.connect()
    s0 = _snap()
    c_result = {}

    def c_pull():
        store_c = osm.LocalStore()
        c_result["stored"] = pull_object(conn_cb, oid, timeout=30,
                                         store=store_c)
        c_result["store"] = store_c

    tc = threading.Thread(target=c_pull)
    tc.start()
    # C must be parked on a not-yet-landed chunk of B's landing
    _wait_for(lambda: _delta(s0, "partial_waits") >= 1,
              msg="C to park on B's landing")
    assert _delta(s0, "partial_serves") == 1        # C's session on B
    assert "stored" not in c_result
    gate1.set()                                     # unstall B's pull
    tb.join(30)
    tc.join(30)
    assert b_result.get("stored") is not None
    assert c_result.get("stored") is not None
    np.testing.assert_array_equal(
        osm.deserialize(c_result["stored"]), payload)
    # C was served by B, not A
    assert ep_b.server.serves_per_object().get(oid) == 1
    assert ep_a.server.serves_per_object().get(oid) == 1   # B only
    c_result["store"].shutdown()
    store_b.shutdown()
    store_a.shutdown()
    ep_a.close()
    ep_b.close()


def test_cut_through_reroot_on_relay_failure():
    """Byte equality under an injected mid-cut-through failure: C is
    parked on partial holder B when B's own pull dies -> C's parked
    chunk answers dropped, C's session re-open finds nothing at B,
    and C's pull manager re-roots on the source A."""
    payload = np.arange(1_500_000, dtype=np.float64)         # 3 chunks
    store_a = osm.LocalStore()
    obj = osm.serialize(payload)
    store_a.put_stored(obj)
    oid = obj.object_id

    ep_a = _Endpoint(store_a)
    fail_b = {"on": False}
    gate_fail = threading.Event()       # armed -> chunk 1+ answers drop
    real_chunk = ep_a.server.handle_chunk

    def failing_chunk(c, msg):
        if fail_b["on"] and msg["index"] >= 1:
            # stall B at chunk 1 (so C has time to park on B's
            # landing), then answer with a drop: holder lost state
            gate_fail.wait(15)
            c.reply(msg, data=None)
            return
        real_chunk(c, msg)

    ep_a.server.handle_chunk = failing_chunk
    real_pull = ep_a.server.handle_pull
    opens = {"n": 0}

    def failing_pull(c, msg):
        # B's FIRST open succeeds (chunk 0 lands); once failure mode
        # is armed, retry re-opens are refused — B is done for
        opens["n"] += 1
        if fail_b["on"] and opens["n"] > 1:
            c.reply(msg, found=False)
            return
        real_pull(c, msg)

    ep_a.server.handle_pull = failing_pull

    store_b = osm.LocalStore()
    ep_b = _Endpoint(store_b)
    conn_ab = ep_a.connect()

    b_result = {}

    def b_pull():
        fail_b["on"] = True
        b_result["stored"] = pull_object(conn_ab, oid, timeout=30,
                                         retries=1, store=store_b)

    # phase 1: B lands chunk 0, then A starts failing B
    tb = threading.Thread(target=b_pull)
    tb.start()
    _wait_for(lambda: (landing_table(store_b).get(oid) is not None
                       and landing_table(store_b).get(oid).n_landed >= 1),
              msg="B's first chunk to land")
    b_segments = list(landing_table(store_b).get(oid).shm_names)
    assert b_segments

    # phase 2: C starts pulling from B (partial holder), parks
    conn_cb = ep_b.connect()
    conn_ca = ep_a.connect()
    s0 = _snap()
    store_c = osm.LocalStore()
    gate_a = threading.Event()

    def c_sources(o, prefer):
        yield ("B", conn_cb)
        gate_a.wait(15)                # main thread re-arms A first
        yield ("A", conn_ca)

    mgr = PullManager(store_c, sources_fn=c_sources)
    c_result = {}

    def c_pull():
        c_result["stored"] = mgr.pull(oid, timeout=40)

    tc = threading.Thread(target=c_pull)
    tc.start()
    _wait_for(lambda: _delta(s0, "partial_waits") >= 1,
              msg="C to park on B's landing")

    # phase 3: B's pull dies (chunk 1 dropped, re-open refused)
    gate_fail.set()
    tb.join(30)
    assert b_result.get("stored") is None, "B's pull must fail"
    assert landing_table(store_b).get(oid) is None
    # B's landing segments are reclaimed as soon as C's (now useless)
    # cut-through session drops — not TTL-deferred (C's OWN in-flight
    # landing still legitimately exists at this point)
    _wait_for(lambda: not any(
        __import__("os").path.exists("/dev/shm/" + n)
        for n in b_segments),
        msg="B's failed-landing segments to be reclaimed")

    # phase 4: A serves normally again; C re-roots and completes
    fail_b["on"] = False
    gate_a.set()
    tc.join(40)
    assert c_result.get("stored") is not None, \
        "C must recover by re-rooting on the source"
    np.testing.assert_array_equal(
        osm.deserialize(c_result["stored"]), payload)
    assert _delta(s0, "pulls_completed") == 1
    store_c.shutdown()
    store_b.shutdown()
    store_a.shutdown()
    ep_a.close()
    ep_b.close()


# ------------------------------------------- directory partial state
def test_directory_partial_holders():
    d = ObjectDirectory()
    events = []
    d.add_listener(lambda oid, nid, partial: events.append(
        (oid, nid, partial)))
    # partial add: advisory only
    assert d.add("o1", "nA", nbytes=64, partial=True)
    assert d.locations("o1") == []          # not a real copy
    assert not d.has("o1")
    assert d.holds_partial("o1", "nA")
    assert d.partial_locations("o1") == ["nA"]
    assert d.nbytes("o1") == 64             # size is known regardless
    assert events == [("o1", "nA", True)]
    # re-add: no event
    assert not d.add("o1", "nA", partial=True)
    # promotion: full add supersedes and clears the partial entry
    assert d.add("o1", "nA", nbytes=64)
    assert d.locations("o1") == ["nA"]
    assert not d.holds_partial("o1", "nA")
    assert events[-1] == ("o1", "nA", False)
    # a partial add for a node already holding a full copy is a no-op
    assert not d.add("o1", "nA", partial=True)
    assert not d.holds_partial("o1", "nA")

    # node death drops partial holders everywhere; partial-only
    # objects orphan when their full holders die (a relay whose source
    # died can never finish)
    d.add("o2", "nB", nbytes=10)
    d.add("o2", "nC", partial=True)
    assert d.purge_node("nC") == []         # only a partial lost
    assert not d.holds_partial("o2", "nC")
    d.add("o2", "nC", partial=True)
    assert d.purge_node("nB") == ["o2"]     # sole FULL copy gone
    assert not d.holds_partial("o2", "nC")  # partial dropped with it

    # retraction (failed relay pull): remove() clears the partial
    d.add("o3", "nD", nbytes=5)
    d.add("o3", "nE", partial=True)
    d.remove("o3", "nE")
    assert not d.holds_partial("o3", "nE")
    assert d.locations("o3") == ["nD"]
    # stats surface
    st = d.stats()
    assert st["partial_adds"] >= 4 and st["partial_replicas"] == 0


def test_cut_through_disabled_by_knob(monkeypatch):
    """RAY_TPU_PULL_CUT_THROUGH=0: landings never register in the
    table, so a mid-pull holder serves nothing (child gets
    found=False and rotates)."""
    monkeypatch.setenv("RAY_TPU_PULL_CUT_THROUGH", "0")
    CONFIG.reload()
    try:
        payload = np.arange(600_000, dtype=np.float64)
        src = osm.LocalStore()
        obj = osm.serialize(payload)
        src.put_stored(obj)
        gate = threading.Event()
        ep_a = _throttled_source(src, {1: gate})
        store_b = osm.LocalStore()
        ep_b = _Endpoint(store_b)
        conn = ep_a.connect()
        res = {}
        t = threading.Thread(target=lambda: res.update(
            s=pull_object(conn, obj.object_id, timeout=30,
                          store=store_b)))
        t.start()
        time.sleep(0.3)
        assert landing_table(store_b).get(obj.object_id) is None
        conn_cb = ep_b.connect()
        meta = conn_cb.request({"type": protocol.PULL_OBJECT,
                                "object_id": obj.object_id,
                                "manifest": True}, timeout=10)
        assert not meta.get("found")
        gate.set()
        t.join(30)
        np.testing.assert_array_equal(osm.deserialize(res["s"]),
                                      payload)
        store_b.shutdown()
        src.shutdown()
        ep_a.close()
        ep_b.close()
    finally:
        monkeypatch.delenv("RAY_TPU_PULL_CUT_THROUGH", raising=False)
        CONFIG.reload()
