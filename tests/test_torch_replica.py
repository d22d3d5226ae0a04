"""The port's replica tier against `repro`'s, bottom-up.

The router's QueryQueue policies (admission control + coalescing) in
isolation, the router's counters, the wire protocol (byte for byte the
reference's), the publish/ack barrier records and the `ServeSpec`
round trips — the tests of `tests/test_replica.py`, run against the
port's module. Then the cross-package contract: the port's updater
publishes the reference updater's steps byte for byte, a port reader and
a reference reader answer the same padded batches alike, the reference
restores the port's steps. The reader's two staleness rules (it joins
the barrier before its first map, and acks a flip only once the answers
at older versions are sent). Last, the crash-recovery scenario on the
CPU: a reader killed mid-stream, restarted from ``CURRENT``, every answer
checked against the Dijkstra oracle at the version that served it, and
staleness ≤ 1 across the process boundary.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import filecmp
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from repro.core import snapshot as jsnap
from repro.launch import config as jconfig
from repro.launch import replica as jrep
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import snapshot as tsnap
from repro_torch.launch import config as tconfig
from repro_torch.launch import replica
from repro_torch.launch.config import (EngineSpec, GraphSpec, ServeSpec,
                                       StreamSpec, TopologySpec,
                                       build_parser, spec_from_cli)
from repro_torch.launch.replica import QueryQueue


# ---------------------------------------------------------------------------
# QueryQueue: admission control
# ---------------------------------------------------------------------------

def test_admission_counts_queries_not_requests():
    q = QueryQueue(max_pending=10, microbatch=32, coalesce_s=0.0)
    assert q.offer("a", 6)
    assert q.offer("b", 4)          # exactly at the cap
    assert q.pending == 10
    assert not q.offer("c", 1)      # one over: refused
    assert q.rejected == 1
    assert q.pending == 10          # refusal left the queue untouched


def test_admission_exempts_front_requeue():
    q = QueryQueue(max_pending=4, microbatch=32, coalesce_s=0.0)
    assert q.offer("a", 4)
    assert not q.offer("b", 1)
    assert q.offer("requeued", 3, front=True)
    assert q.pending == 7
    assert q.take() == ["requeued", "a"]  # head position preserved


def test_front_requeue_never_counts_as_rejected():
    q = QueryQueue(max_pending=4, microbatch=32, coalesce_s=0.0)
    assert q.offer("a", 4)
    assert not q.offer("b", 2)
    assert q.rejected == 2
    assert q.offer("r", 3, front=True)   # reclaimed batch
    assert q.rejected == 2               # exempt → uncounted
    assert q.pending == 7
    assert q.take() == ["r", "a"]
    assert q.pending == 0


def test_coalesce_split_refusal_leaves_counters_intact():
    q = QueryQueue(max_pending=100, microbatch=8, coalesce_s=0.01)
    q.offer("a", 6)
    q.offer("b", 5)                  # 6+5 > 8: left whole for next take
    assert q.take() == ["a"]
    assert q.pending == 5
    assert q.rejected == 0
    assert q.take() == ["b"]
    assert q.pending == 0


# ---------------------------------------------------------------------------
# Router counters
# ---------------------------------------------------------------------------

def _router(tmp_path, microbatch=4, max_queue=2, readers=()):
    spec = ServeSpec(
        stream=StreamSpec(microbatch=microbatch, quiet=True),
        topology=TopologySpec(max_queue=max_queue))
    return replica.Router(spec, str(tmp_path), port=0,
                          reader_addrs=list(readers))


def test_router_counts_oversized_and_rejected_once(tmp_path):
    router = _router(tmp_path, microbatch=4, max_queue=2)
    client, server = socket.socketpair()
    t = threading.Thread(target=router._client_loop, args=(server,),
                         daemon=True)
    t.start()
    try:
        big = np.arange(6, dtype=np.int32)       # > microbatch
        replica.send_msg(client, replica.MSG_QUERY,
                         replica.pack_query(big, big))
        kind, _ = replica.recv_msg(client)
        assert kind == replica.MSG_REJECT
        two = np.arange(2, dtype=np.int32)       # fills max_queue exactly
        replica.send_msg(client, replica.MSG_QUERY,
                         replica.pack_query(two, two))
        one = np.arange(1, dtype=np.int32)       # one over: refused
        replica.send_msg(client, replica.MSG_QUERY,
                         replica.pack_query(one, one))
        kind, _ = replica.recv_msg(client)
        assert kind == replica.MSG_REJECT
        replica.send_msg(client, replica.MSG_STATS)
        kind, payload = replica.recv_msg(client)
        assert kind == replica.MSG_STATS
        stats = json.loads(payload)
        assert stats["oversized"] == 6
        assert stats["rejected"] == 1
        assert router.queue.rejected == 1
        assert stats["pending"] == 2
    finally:
        replica.send_msg(client, replica.MSG_STOP)
        t.join(timeout=5.0)
        client.close()
    assert not t.is_alive()


def test_router_requeued_counts_queries_not_entries(tmp_path):
    """One reclaimed 3-query batch counts as 3, and whoever sees the
    count also sees the batch back in the queue: the router re-offers
    before it counts (the reference counts first, `ROADMAP.md` § 3), so
    `pending` is checked at once at the first non-zero `requeued`, in
    each of 20 rounds, with the interpreter switching threads as often
    as it can so that a window between the two would show."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            _requeue_round(tmp_path)
    finally:
        sys.setswitchinterval(switch)


def _requeue_round(tmp_path):
    """One reader that takes a batch and dies; the router's counters and
    queue at the first non-zero `requeued`."""
    srv = socket.create_server(("127.0.0.1", 0))
    addr = srv.getsockname()

    def accept_and_drop(srv=srv):
        conn, _ = srv.accept()
        srv.close()                  # no reconnect: one failure
        replica.recv_msg(conn)       # take the dispatched batch...
        conn.close()                 # ...and die before answering

    dropper = threading.Thread(target=accept_and_drop, daemon=True)
    dropper.start()
    router = _router(tmp_path, microbatch=8, max_queue=16,
                     readers=[addr])
    qs = np.arange(3, dtype=np.int32)
    entry = replica._Entry(None, threading.Lock(), qs, qs)
    assert router.queue.offer(entry, qs.size)
    t = threading.Thread(target=router._dispatch_loop, args=(0,),
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 10.0
        seen = None
        while time.monotonic() < deadline and seen is None:
            with router._stats_lock:
                if router.stats["requeued"]:
                    seen = (router.stats["requeued"],
                            router.stats["reader_errors"][0],
                            router.queue.pending)
            time.sleep(0)   # poll as often as the GIL allows
        assert seen == (3, 1, 3)
    finally:
        router.running = False
        t.join(timeout=5.0)
        dropper.join(timeout=5.0)
    assert not t.is_alive() and not dropper.is_alive()


# ---------------------------------------------------------------------------
# QueryQueue: coalescing
# ---------------------------------------------------------------------------

def test_coalesce_merges_up_to_microbatch():
    q = QueryQueue(max_pending=100, microbatch=8, coalesce_s=10.0)
    for name, m in (("a", 3), ("b", 3), ("c", 2), ("d", 1)):
        q.offer(name, m)
    t0 = time.monotonic()
    assert q.take() == ["a", "b", "c"]
    assert time.monotonic() - t0 < 5.0
    assert q.pending == 1


def test_coalesce_never_splits_entries():
    q = QueryQueue(max_pending=100, microbatch=8, coalesce_s=0.01)
    q.offer("a", 5)
    q.offer("b", 5)
    assert q.take() == ["a"]
    assert q.take() == ["b"]


def test_coalesce_dispatches_oversized_alone():
    q = QueryQueue(max_pending=100, microbatch=8, coalesce_s=0.01)
    q.offer("big", 20)
    q.offer("small", 1)
    assert q.take() == ["big"]
    assert q.take() == ["small"]


def test_coalesce_window_closes_on_partial_batch():
    q = QueryQueue(max_pending=100, microbatch=32, coalesce_s=0.05)
    q.offer("a", 2)
    t0 = time.monotonic()
    assert q.take(timeout=5.0) == ["a"]
    assert time.monotonic() - t0 < 2.0


def test_take_empty_after_timeout():
    q = QueryQueue(max_pending=10, microbatch=8, coalesce_s=0.01)
    assert q.take(timeout=0.01) == []


def test_take_picks_up_late_arrivals_inside_window():
    q = QueryQueue(max_pending=100, microbatch=8, coalesce_s=0.5)
    got = []
    t = threading.Thread(target=lambda: got.extend(q.take(timeout=2.0)))
    q.offer("a", 2)
    t.start()
    time.sleep(0.05)
    q.offer("b", 2)
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert got == ["a", "b"]


# ---------------------------------------------------------------------------
# Wire protocol: the reference's bytes
# ---------------------------------------------------------------------------

def test_query_answer_pack_roundtrip():
    qs = np.arange(5, dtype=np.int32)
    qt = np.arange(5, 10, dtype=np.int32)
    qs2, qt2 = replica.unpack_query(replica.pack_query(qs, qt))
    np.testing.assert_array_equal(qs, qs2)
    np.testing.assert_array_equal(qt, qt2)
    v, h, d = replica.unpack_answer(
        replica.pack_answer(7, 8, np.asarray([1, 2, 3], np.int32)))
    assert (v, h) == (7, 8)
    np.testing.assert_array_equal(d, [1, 2, 3])


def test_message_kinds_and_header_match_reference():
    for name in ("MSG_QUERY", "MSG_ANSWER", "MSG_REJECT", "MSG_PING",
                 "MSG_PONG", "MSG_STATS", "MSG_STOP"):
        assert getattr(replica, name) == getattr(jrep, name), name
    assert replica._HDR.format == jrep._HDR.format


@pytest.mark.parametrize("m", [0, 1, 5, 32])
def test_wire_bytes_match_reference(m):
    """The same numpy inputs give the same bytes in both packages, and
    each package decodes the other's."""
    rng = np.random.default_rng(m)
    qs = rng.integers(0, 1 << 20, m).astype(np.int64)   # cast on packing
    qt = rng.integers(0, 1 << 20, m).astype(np.int32)
    d = rng.integers(0, 1 << 28, m).astype(np.int32)
    assert replica.pack_query(qs, qt) == jrep.pack_query(qs, qt)
    assert replica.pack_answer(3, 4, d) == jrep.pack_answer(3, 4, d)
    for a, b in zip(replica.unpack_query(jrep.pack_query(qs, qt)),
                    (qs, qt)):
        np.testing.assert_array_equal(a, b)
    v, h, got = jrep.unpack_answer(replica.pack_answer(3, 4, d))
    assert (v, h) == (3, 4)
    np.testing.assert_array_equal(got, d)
    # Framed on a socket: the port's sender, the reference's receiver.
    a, b = socket.socketpair()
    with a, b:
        replica.send_msg(a, replica.MSG_QUERY, replica.pack_query(qs, qt))
        kind, payload = jrep.recv_msg(b)
        assert (kind, payload) == (jrep.MSG_QUERY, jrep.pack_query(qs, qt))
        jrep.send_msg(b, jrep.MSG_ANSWER, jrep.pack_answer(1, 2, d))
        assert replica.recv_msg(a) == (replica.MSG_ANSWER,
                                       replica.pack_answer(1, 2, d))


# ---------------------------------------------------------------------------
# Publish/ack records (the barrier's inputs)
# ---------------------------------------------------------------------------

def test_publish_requires_saved_step(tmp_path):
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.publish(d, 3)
    ckpt.save(d, 3, {"x": np.arange(4)})
    rec = ckpt.publish(d, 3)
    assert rec["version"] == 3
    assert ckpt.current_step(d) == 3


def test_prune_never_removes_published_step(tmp_path):
    d = str(tmp_path)
    for s in range(5):
        ckpt.save(d, s, {"x": np.arange(4) + s})
    ckpt.publish(d, 1)
    ckpt.prune(d, keep=2)
    assert ckpt.current_step(d) == 1
    assert ckpt.step_manifest(d, 1) is not None
    assert ckpt.step_manifest(d, 4) is not None
    assert ckpt.step_manifest(d, 0) is None


def test_prune_keeps_steps_between_current_and_latest(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        ckpt.save(d, s, {"x": np.arange(4) + s})
    ckpt.publish(d, 2)
    ckpt.prune(d, keep=1)
    for s in range(2, 6):
        assert ckpt.step_manifest(d, s) is not None, s
    assert ckpt.step_manifest(d, 0) is None
    assert ckpt.step_manifest(d, 1) is None
    d2 = str(tmp_path / "unpublished")
    for s in range(3):
        ckpt.save(d2, s, {"x": np.arange(4) + s})
    ckpt.prune(d2, keep=1)
    assert ckpt.step_manifest(d2, 2) is not None
    assert ckpt.step_manifest(d2, 0) is None


def test_ack_barrier_ignores_dead_readers(tmp_path):
    d = str(tmp_path)
    replica.write_ack(d, 0, version=5)               # live: this process
    p = subprocess.Popen(["true"])
    p.wait()
    replica.write_ack(d, 1, version=0)
    rec = dict(replica.read_acks(d)[1])
    rec["pid"] = p.pid
    ckpt.write_json_atomic(os.path.join(d, "acks", "reader_1.json"), rec)
    assert replica.wait_for_acks(d, version=5, timeout_s=5.0)
    # The ack records are the reference's: its barrier reads them too.
    assert jrep.read_acks(d) == replica.read_acks(d)


def test_ack_barrier_times_out_on_live_laggard(tmp_path):
    d = str(tmp_path)
    replica.write_ack(d, 0, version=1)               # live (us), behind
    t0 = time.monotonic()
    assert not replica.wait_for_acks(d, version=2, timeout_s=0.1,
                                     log=lambda *a: None)
    assert time.monotonic() - t0 < 2.0


# ---------------------------------------------------------------------------
# ServeSpec round trips (the spec every role is launched from)
# ---------------------------------------------------------------------------

def _nondefault_spec() -> ServeSpec:
    return ServeSpec(
        graph=GraphSpec(n=500, deg=3, landmarks=8, capacity=640, grow=True),
        engine=EngineSpec(backend="pallas", block_v=128, fused=True),
        stream=StreamSpec(batches=3, qps=123.5, pipeline=True, verify=True),
        topology=TopologySpec(readers=3, coalesce_ms=5.0, restart=True))


def test_spec_cli_roundtrip():
    spec = _nondefault_spec()
    ns = build_parser("t").parse_args(spec.to_args())
    assert ServeSpec.from_parsed_args(ns) == spec


def test_spec_json_roundtrip(tmp_path):
    spec = _nondefault_spec()
    path = str(tmp_path / "spec.json")
    spec.save_json(path)
    assert ServeSpec.load_json(path) == spec
    # Either package's roles load one deployment's document.
    assert jconfig.ServeSpec.load_json(path).to_json() == spec.to_json()


def test_spec_serve_config_roundtrip():
    spec = _nondefault_spec()
    cfg = spec.to_serve_config()
    assert cfg.n == 500 and cfg.backend == "pallas" and cfg.qps == 123.5
    assert ServeSpec.from_serve_config(cfg, topology=spec.topology) == spec


def test_flat_flags_alone_are_the_spec():
    ap = build_parser("t")
    ns = ap.parse_args(["--n", "700"])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        spec = spec_from_cli(ns, ap)
    assert spec.graph.n == 700
    assert not w


def test_flat_overrides_alongside_config_warn_deprecated(tmp_path):
    path = str(tmp_path / "spec.json")
    _nondefault_spec().save_json(path)
    ap = build_parser("t")
    ns = ap.parse_args(["--config", path, "--n", "700"])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        spec = spec_from_cli(ns, ap)
    assert spec.graph.n == 700
    assert spec.engine.backend == "pallas"
    assert any(issubclass(x.category, DeprecationWarning) for x in w)


def test_realized_n_road_rounds_to_grid():
    gs = GraphSpec(n=2025, graph="road")
    rows = max(2, math.isqrt(2025))
    assert gs.realized_n() == rows * max(2, (2025 + rows - 1) // rows)
    assert GraphSpec(n=2025).realized_n() == 2025


# ---------------------------------------------------------------------------
# Cross-package: the updaters publish the same steps, the readers answer
# the same padded batches
# ---------------------------------------------------------------------------

TIER = dict(graph=dict(n=300, deg=3, landmarks=8),
            stream=dict(batches=3, batch_size=30, queries=0, microbatch=16,
                        pipeline=True, seed=3, quiet=True),
            topology=dict(readers=2, restart=True))


def _spec(cfg):
    """`TIER` as a `ServeSpec` of the package whose config module is
    `cfg`."""
    return cfg.ServeSpec(graph=cfg.GraphSpec(**TIER["graph"]),
                         stream=cfg.StreamSpec(**TIER["stream"]),
                         topology=cfg.TopologySpec(**TIER["topology"]))


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """Each package's updater, run in this process on the same spec:
    (the port's publish dir, the reference's)."""
    port = str(tmp_path_factory.mktemp("port_pub"))
    ref = str(tmp_path_factory.mktemp("ref_pub"))
    replica.updater_main(_spec(tconfig), port, device="cpu")
    jrep.updater_main(_spec(jconfig), ref)
    return port, ref


def test_updater_publishes_the_reference_steps(published):
    port, ref = published
    assert ckpt.current_step(port) == ckpt.current_step(ref) == 3
    steps = sorted(d for d in os.listdir(ref) if d.startswith("step_"))
    assert steps == [f"step_{v}" for v in range(4)]
    assert sorted(d for d in os.listdir(port)
                  if d.startswith("step_")) == steps
    for step in steps:
        names = sorted(os.listdir(os.path.join(ref, step)))
        assert "edge_list.npy" in names and "base_n.npy" in names
        assert sorted(os.listdir(os.path.join(port, step))) == names
        _, mismatch, errors = filecmp.cmpfiles(
            os.path.join(port, step), os.path.join(ref, step), names,
            shallow=False)
        assert not mismatch and not errors, (step, mismatch, errors)


def test_reference_restores_the_port_steps(published):
    port, _ = published
    for v in range(4):
        got = jsnap.restore_snapshot(port, step=v, mmap=True)
        want = tsnap.restore_snapshot(port, step=v, device="cpu")
        assert got.version == want.version == v
        for part, fields in (("graph", ("src", "dst", "valid", "w")),
                             ("labelling", ("landmarks", "dist", "hub",
                                            "highway"))):
            for f in fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(getattr(got, part), f)),
                    getattr(getattr(want, part), f).numpy())


@pytest.fixture(scope="module")
def readers(published):
    """A port reader and a reference reader on the port's publish dir,
    each with its engine built (not serving)."""
    port, _ = published
    t = replica._ReaderServer(_spec(tconfig), port, 0, 10,
        device="cpu")
    j = jrep._ReaderServer(_spec(jconfig), port, 0, 11)
    t._build_engine()
    j._build_engine()
    return t, j


@pytest.mark.parametrize("m", [1, 5, 16])
def test_readers_answer_padded_batches_like_the_reference(readers, m):
    """Buckets {1, 8, 16}: m = 5 pads to 8 with copies of query 0."""
    t, j = readers
    assert t._buckets() == j._buckets() == [1, 8, 16]
    rng = np.random.default_rng(m)
    qs = rng.integers(0, 300, m).astype(np.int32)
    qt = rng.integers(0, 300, m).astype(np.int32)
    for v in range(4):
        t._map_version(v)
        j._map_version(v)
        got, gv = t.answer(qs, qt)
        want, jv = j.answer(qs, qt)
        assert gv == jv == v
        assert got.dtype == np.int32 and got.shape == (m,)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert replica.read_acks(t.publish_dir)[10]["version"] == 3


def test_reader_engine_is_the_serve_loops(tmp_path):
    """A reader builds its engine as the serve loop does (`serve_engine`),
    without the frontier mode, and with mesh="host" its host mesh, whose
    landmark groupings it validates."""
    spec = ServeSpec(engine=EngineSpec(block_v=128, block_e=64,
                                       frontier=True))
    r = replica._ReaderServer(spec, str(tmp_path), 0, 0, device="cpu")
    r._build_engine()
    assert (r._engine.block_v, r._engine.block_e) == (128, 64)
    assert not r._engine.frontier
    assert r._mesh is None
    spec = ServeSpec(engine=EngineSpec(mesh="host"))
    r = replica._ReaderServer(spec, str(tmp_path), 0, 0, device="cpu")
    r._build_engine()
    assert r._mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="must divide the 1 local devices"):
        replica._ReaderServer(
            ServeSpec(engine=EngineSpec(mesh="host", shards=2)),
            str(tmp_path), 0, 0, device="cpu")._build_engine()


def test_reader_acks_a_flip_after_older_answers_are_sent(published):
    """While an answer at v0 is in flight, the flip to v1 is made but
    not acked: the ack lets the updater publish v2, and the answer at v0
    would then be two versions behind the head."""
    port, _ = published
    spec = _spec(tconfig)
    r = replica._ReaderServer(spec, port, 0, 20, device="cpu")
    r._build_engine()
    r._map_version(0)
    flip = threading.Thread(target=r._map_version, args=(1,), daemon=True)
    with r._pinned() as snap:
        assert snap.version == 0
        flip.start()
        deadline = time.monotonic() + 10.0
        while r._snap.version != 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert r._snap.version == 1          # new queries see v1 ...
        time.sleep(0.2)
        assert replica.read_acks(port)[20]["version"] == 0   # ... no ack
    flip.join(timeout=10.0)
    assert not flip.is_alive()
    assert replica.read_acks(port)[20]["version"] == 1


def test_starting_reader_joins_the_barrier_before_mapping(tmp_path,
                                                          published):
    """A reader's first act on finding CURRENT is an ack one below it, so
    the updater waits for its first map instead of publishing past it."""
    port, _ = published
    d = str(tmp_path)
    for v in (0, 1):
        os.symlink(os.path.join(port, f"step_{v}"),
                   os.path.join(d, f"step_{v}"))
    ckpt.publish(d, 1)
    spec = _spec(tconfig)
    r = replica._ReaderServer(spec, d, replica.free_port(), 0, device="cpu")
    acks = []
    mapped = r._map_version

    def map_version(v):
        acks.append(replica.read_acks(d)[0]["version"])
        mapped(v)
        r.running = False
    r._map_version = map_version
    t = threading.Thread(target=r.serve_forever, daemon=True)
    t.start()
    t.join(timeout=30.0)
    assert not t.is_alive()
    assert acks[0] == 0                       # joined at CURRENT − 1
    assert replica.read_acks(d)[0]["version"] == 1


# ---------------------------------------------------------------------------
# Crash recovery: kill a reader mid-stream, restart from CURRENT,
# zero wrong answers at each answer's served version, staleness <= 1.
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_reader_crash_recovery(tmp_path):
    spec = ServeSpec(
        graph=GraphSpec(n=300, deg=3, landmarks=8),
        stream=StreamSpec(batches=3, batch_size=30, queries=0,
                          microbatch=16, seed=3, quiet=True),
        topology=TopologySpec(readers=2, restart=True))
    topo = replica.ReplicaTopology(spec, str(tmp_path), device="cpu")
    killed = [False]

    def kill_once():
        if not killed[0] and time.monotonic() > t_kill[0]:
            killed[0] = True
            topo.kill_reader(0)

    try:
        topo.start()
        t_kill = [time.monotonic() + 1.0]
        report = replica.stream_queries(spec, topo, total=240, qps=120.0,
                                        on_tick=kill_once)
        assert killed[0]
        assert topo.updater_ok()
        assert topo.reader_restarts >= 1
        assert report.offered == 240
        assert len(report.answers) + report.rejected == 240
        assert len(report.answers) >= 200
        assert report.max_staleness() <= 1
        assert replica.verify_answers(str(tmp_path), report.answers) == 0
    finally:
        topo.stop()


def test_tier_serves_on_a_host_mesh(tmp_path):
    """The tier with mesh="host" on the CPU: the updater's loop and each
    reader run on their host mesh (1×1 here; the reader's map lines name
    it), the reader answers through the sharded query, and every answer
    equals the Dijkstra oracle at the version that served it."""
    spec = ServeSpec(
        graph=GraphSpec(n=300, deg=3, landmarks=8),
        engine=EngineSpec(mesh="host"),
        stream=StreamSpec(batches=2, batch_size=30, queries=0,
                          microbatch=16, seed=3, pipeline=True),
        topology=TopologySpec(readers=1))
    pub, logs = str(tmp_path / "pub"), str(tmp_path / "logs")
    os.makedirs(pub)
    topo = replica.ReplicaTopology(spec, pub, device="cpu", log_dir=logs)
    try:
        topo.start()
        report = replica.stream_queries(spec, topo, total=60, qps=100.0)
        assert topo.updater_ok() or topo.updater_running()
        assert len(report.answers) + report.rejected == 60
        assert len(report.answers) >= 50 and report.max_staleness() <= 1
        assert replica.verify_answers(pub, report.answers) == 0
    finally:
        topo.stop()
    with open(os.path.join(logs, "reader_0.log")) as fh:
        maps = [json.loads(line.split("replica map: ", 1)[1])
                for line in fh if "replica map: " in line]
    assert maps and all(m["mesh"] == {"data": 1, "model": 1} for m in maps)

