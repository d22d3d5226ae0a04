"""The multi-replica serve tier: single-writer updater, N reader
replicas, and a coalescing router — process topology as configuration.

The port of `repro.launch.replica`, with the same names, roles, wire
protocol (byte for byte) and on-disk publish format, so a port process
and a reference process can sit on either side of a socket or of a
publish directory. One `ServeLoop` process owns both updates and queries,
and every query of a tick waits behind the tick's host tiling. This
module splits the single-writer/many-reader seam that `SnapshotStore`
already implies in-process across *process* boundaries (DESIGN.md §9):

* **updater** — runs the (pipelined, fused, autotuned) batch-update loop
  of `ServeLoop` with the query stream turned off, and commits each
  version *durably*: the step tree is fsync'd and atomically renamed by
  `core/snapshot.save_snapshot`, and only then is the ``CURRENT``
  pointer flipped (`checkpoint/manager.publish`). Before publishing
  version v it waits for every live reader to ack v−1 (the publish
  barrier), so no reader is ever two published versions behind.

* **reader** (×N) — maps the step ``CURRENT`` names (`restore_snapshot`
  with ``mmap=True``: N readers share one page-cache copy of the step on
  the host; each holds its own copy on the device), prepares a query
  plan, answers query microbatches over TCP, and acks each version it
  flips to via an atomic ack record. A new version is mapped, tiled and
  warmed in the reader's poll thread while it keeps answering at the old
  one. A reader that crashes is restarted from ``CURRENT`` and resumes
  exactly — the pointer only ever names fsync'd steps.

* **router** — the client-facing door: admission control (reject beyond
  ``max_queue`` pending queries), microbatch coalescing (merge small
  client requests into reader-sized batches within a ``coalesce_ms``
  window — `QueryQueue`, unit-tested in isolation), per-reader health
  (a failed dispatch requeues its batch for the others, marks the reader
  down and retries the connection in the background) and staleness
  accounting per answer (published head version − answered version).

Every role is launched from ONE serialized `ServeSpec`
(`launch/config.py`) plus its role-local flags (port, reader id, device):

    python -m repro_torch.launch.replica --role serve --readers 2 --verify ...

spawns and supervises the whole topology (the ``serve`` role also
drives an open-loop client stream and, with ``--verify``, checks every
answer against the Dijkstra oracle at the version it was served —
exactly the `ServeLoop --verify` contract, across process boundaries).
Every role runs on the GPU unless it is given ``--device cpu``, and
raises without one. Each role prints one ``replica exit: {...}`` JSON
line when it stops (`MSG_STOP`, SIGTERM or the end of its run) with its
kernel launch counts and peak device bytes, since the launches happen in
its own process.

Staleness ≤ 1 survives the boundary because (a) a reader only flips to
a version whose publish record — and the step it names — are fsync'd,
(b) the updater's publish barrier keeps any acked reader within one
published version of head, and (c) answers carry the version they were
computed at, so the router can always account the lag it served.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Wire protocol: tiny length-framed messages over localhost TCP
# ---------------------------------------------------------------------------

MSG_QUERY = 1    # -> router/reader:  u32 m | i32 qs[m] | i32 qt[m]
MSG_ANSWER = 2   # <- router/reader:  i64 version | i64 head | u32 m | i32 d[m]
MSG_REJECT = 3   # <- router:         utf-8 reason (admission control)
MSG_PING = 4     # -> reader:         empty
MSG_PONG = 5     # <- reader:         i64 version
MSG_STATS = 6    # -> router: empty   <- router: utf-8 JSON
MSG_STOP = 7     # -> router/reader:  empty; peer exits cleanly

_HDR = struct.Struct("<BI")


def send_msg(sock: socket.socket, kind: int, payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(kind, len(payload)) + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket) -> tuple[int, bytes]:
    kind, ln = _HDR.unpack(recv_exact(sock, _HDR.size))
    return kind, (recv_exact(sock, ln) if ln else b"")


def pack_query(qs: np.ndarray, qt: np.ndarray) -> bytes:
    qs = np.asarray(qs, np.int32).ravel()
    qt = np.asarray(qt, np.int32).ravel()
    return struct.pack("<I", qs.size) + qs.tobytes() + qt.tobytes()


def unpack_query(payload: bytes) -> tuple[np.ndarray, np.ndarray]:
    (m,) = struct.unpack_from("<I", payload)
    qs = np.frombuffer(payload, np.int32, m, 4)
    qt = np.frombuffer(payload, np.int32, m, 4 + 4 * m)
    return qs, qt


def pack_answer(version: int, head: int, d: np.ndarray) -> bytes:
    d = np.asarray(d, np.int32).ravel()
    return struct.pack("<qqI", version, head, d.size) + d.tobytes()


def unpack_answer(payload: bytes) -> tuple[int, int, np.ndarray]:
    version, head, m = struct.unpack_from("<qqI", payload)
    return version, head, np.frombuffer(payload, np.int32, m, 20)


# ---------------------------------------------------------------------------
# QueryQueue: admission control + microbatch coalescing (router core)
# ---------------------------------------------------------------------------

class QueryQueue:
    """Bounded FIFO of pending query entries with microbatch coalescing.

    The router's two policies live here, socket-free and unit-testable
    (tests/test_torch_replica.py):

    * **admission control** — `offer` counts *queries* (not requests);
      beyond `max_pending` it refuses, and the caller rejects the client
      immediately instead of letting the queue (and tail latency) grow
      without bound.
    * **coalescing** — `take` blocks for the first entry, then keeps
      gathering whole entries until the batch holds `microbatch` queries
      or `coalesce_s` has elapsed since the batch opened. Entries are
      never split, so each client request is answered at one version.
    """

    def __init__(self, max_pending: int, microbatch: int,
                 coalesce_s: float):
        self.max_pending = max_pending
        self.microbatch = microbatch
        self.coalesce_s = coalesce_s
        self._cv = threading.Condition()
        self._items: deque = deque()
        self._pending = 0          # queries currently queued
        self.rejected = 0          # admission-control refusals (queries)

    @property
    def pending(self) -> int:
        return self._pending

    def offer(self, entry, m: int, front: bool = False) -> bool:
        """Enqueue `entry` carrying `m` queries; False = admission refusal.

        `front=True` requeues a batch reclaimed from a failed reader at
        the head (those queries already waited their turn) and is exempt
        from admission — dropping them would turn a reader crash into
        client-visible rejections.
        """
        with self._cv:
            if not front and self._pending + m > self.max_pending:
                self.rejected += m
                return False
            (self._items.appendleft if front
             else self._items.append)((entry, m))
            self._pending += m
            self._cv.notify()
            return True

    def take(self, timeout: float = 0.1) -> list:
        """One coalesced batch (possibly empty after `timeout`)."""
        with self._cv:
            if not self._items and not self._cv.wait_for(
                    lambda: bool(self._items), timeout):
                return []
            batch, got = [], 0
            opened = time.monotonic()
            while True:
                while self._items and (
                        not batch
                        or got + self._items[0][1] <= self.microbatch):
                    entry, m = self._items.popleft()
                    self._pending -= m
                    batch.append(entry)
                    got += m
                if got >= self.microbatch:
                    break
                remaining = self.coalesce_s - (time.monotonic() - opened)
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
                if not self._items:
                    break
            return batch


# ---------------------------------------------------------------------------
# Publish/ack records (the updater<->reader side channel, via the FS)
# ---------------------------------------------------------------------------

def _ack_dir(publish_dir: str) -> str:
    return os.path.join(publish_dir, "acks")


def write_ack(publish_dir: str, reader_id: int, version: int) -> None:
    os.makedirs(_ack_dir(publish_dir), exist_ok=True)
    ckpt.write_json_atomic(
        os.path.join(_ack_dir(publish_dir), f"reader_{reader_id}.json"),
        {"version": int(version), "pid": os.getpid()})


def read_acks(publish_dir: str) -> dict[int, dict]:
    d = _ack_dir(publish_dir)
    if not os.path.isdir(d):
        return {}
    out = {}
    for name in os.listdir(d):
        if name.startswith("reader_") and name.endswith(".json"):
            rec = ckpt.read_json(os.path.join(d, name))
            if rec is not None:
                out[int(name[len("reader_"):-len(".json")])] = rec
    return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    return True


def wait_for_acks(publish_dir: str, version: int, timeout_s: float,
                  log=print) -> bool:
    """The publish barrier: block until every *live* acked reader is at
    >= `version` (True), or `timeout_s` passed (False — the updater
    proceeds rather than wedging the write path on a stuck reader; the
    event is logged and the stuck reader re-syncs from CURRENT when it
    recovers)."""
    deadline = time.monotonic() + timeout_s
    while True:
        behind = [rid for rid, rec in read_acks(publish_dir).items()
                  if rec["version"] < version and _pid_alive(rec["pid"])]
        if not behind:
            return True
        if time.monotonic() >= deadline:
            log(f"publish barrier timeout: readers {behind} below "
                f"v{version} after {timeout_s:.0f}s; publishing anyway")
            return False
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# Updater role
# ---------------------------------------------------------------------------

def updater_main(spec, publish_dir: str, device=None) -> None:
    """Run the batch-update loop; publish every version durably.

    Exactly `ServeLoop` with the query stream off — the same growth,
    autotune and pipeline semantics — plus the publish protocol on the
    hooks: the initial snapshot and every commit are saved (fsync +
    atomic rename), barrier-gated on reader acks of the previous
    version, and then pointed to by ``CURRENT``. Each publish logs a
    ``replica publish: {...}`` JSON line with the seconds its barrier
    waited.
    """
    from repro_torch.core.snapshot import save_snapshot
    from repro_torch.launch.serve import ServeLoop

    cfg = spec.to_serve_config(
        queries=0, ckpt_dir=publish_dir,
        autotune=spec.engine.autotune or spec.engine.tune_table is not None)
    loop = ServeLoop(cfg, device=device)
    keep = spec.checkpoint.keep

    def edge_state() -> dict:
        # The leaves the loop's own checkpoints carry, so a published
        # step is the reference updater's step byte for byte.
        return {"edge_list": loop.edge_set.edges(),
                "base_n": np.int64(cfg.n)}

    def published(version: int, barrier_s: float, ok: bool) -> None:
        loop._log("replica publish: " + json.dumps(dict(
            version=version, barrier_s=barrier_s, barrier_ok=ok,
            t=time.monotonic())))

    def on_start(snap0) -> None:
        save_snapshot(publish_dir, snap0, extra=edge_state())
        ckpt.publish(publish_dir, snap0.version)
        published(snap0.version, 0.0, True)

    def on_commit(tick: int, snap) -> None:
        # run() already checkpointed `snap` (fsync'd rename); gate the
        # pointer flip on the acks of the *previous* version so no
        # reader observes a head two published versions ahead.
        t0 = time.monotonic()
        ok = wait_for_acks(publish_dir, snap.version - 1,
                           spec.topology.barrier_timeout_s, log=loop._log)
        waited = time.monotonic() - t0
        ckpt.publish(publish_dir, snap.version)
        if keep is not None:
            ckpt.prune(publish_dir, keep=keep)
        published(snap.version, waited, ok)

    loop.on_start = on_start
    loop.on_commit = on_commit
    loop.run()


# ---------------------------------------------------------------------------
# Reader role
# ---------------------------------------------------------------------------

#: routed batches a reader keeps for its stop-time log
BATCH_LOG = 1 << 16


class _ReaderServer:
    """One reader replica: maps the published snapshot, answers queries.

    Single process, thread-per-connection (the router holds one);
    a poller thread watches ``CURRENT`` and swaps the local snapshot —
    the flip is one attribute store, atomic under the GIL, and is acked
    only *after* the new version is mapped and query-ready (warmed), so
    the updater's barrier never counts a reader that could still answer
    at the old version without knowing about the new one.

    Two rules keep an answer within one version of the head, which the
    reference does not enforce (ROADMAP § 3): a reader joins the barrier
    (acks the version before the one it maps) before its first map, so
    the updater cannot publish twice while it starts; and a flip is
    acked only once every answer at an older version has been sent,
    since the ack lets the updater publish the next version.

    `device=None` is the GPU and raises without one. Each map logs a
    ``replica map: {...}`` JSON line: its restore, prepare and warm
    seconds, and when it was acked; on stopping, the reader logs the
    last `BATCH_LOG` routed batches it answered (start, size, seconds)
    as ``replica batches: {...}``.
    """

    def __init__(self, spec, publish_dir: str, port: int, reader_id: int,
                 device=None):
        self.spec = spec
        self.publish_dir = publish_dir
        self.port = port
        self.reader_id = reader_id
        self.device = resolve_device(device)
        self.running = True
        self._snap = None
        self._engine = None
        self._pins: dict[int, int] = {}   # version -> answers in flight
        self._pins_cv = threading.Condition()
        self._batches: deque = deque(maxlen=BATCH_LOG)

    def _log(self, msg: str) -> None:
        if not self.spec.stream.quiet:
            print(msg, flush=True)

    # -- snapshot mapping ---------------------------------------------------

    def _build_engine(self):
        from repro_torch.launch.serve import serve_engine
        e = self.spec.engine
        # Same engine as the updater's ServeLoop (raising for the mesh,
        # as the loop does), without the frontier mode, which only the
        # update waves use: autotuned readers serve the tuner's winner,
        # measured once per snapshot shape at the first prepare.
        cfg = self.spec.to_serve_config(
            autotune=e.autotune or e.tune_table is not None, frontier=False)
        self._engine = serve_engine(cfg, self.device)

    def _buckets(self) -> list[int]:
        """Padding widths of the query path. Coalesced dispatches are
        padded up to the nearest bucket, not always to the full
        microbatch — a 2-query dispatch at low load must not pay a
        32-wide sweep. The reference pads the same way, and the BiBFS
        side choice is made over the whole batch, so a port reader and a
        reference reader answer the same padded batch alike."""
        mb = self.spec.stream.microbatch
        return sorted({1, min(8, mb), mb})

    def _map_version(self, version: int) -> None:
        """Map step `version` (mmap'd leaves), prepare, warm, flip, ack."""
        from repro_torch.core.snapshot import restore_snapshot

        t0 = time.monotonic()
        snap = restore_snapshot(self.publish_dir, step=version, mmap=True,
                                device=self.device)
        t1 = time.monotonic()
        plan = None if self._engine is None else \
            self._engine.prepare(snap.graph)
        snap = dataclasses.replace(snap, plan=plan)
        t2 = time.monotonic()
        # Warm the query path at each serving bucket before the ack: the
        # first launch loads the kernel libraries, and no routed dispatch
        # after a flip should pay that. The pairs are spread over the
        # vertices (the reference's (0, 0) pairs end BiBFS before its
        # first wave, so they would leave the sweep kernel cold).
        n = snap.graph.n
        for w in self._buckets():
            qs = (np.arange(w, dtype=np.int64) * n // w).astype(np.int32)
            self._answer_snap(snap, qs, ((qs + n // 2) % n).astype(np.int32))
        t3 = time.monotonic()
        with self._pins_cv:
            self._snap = snap
            self._pins_cv.wait_for(
                lambda: not any(v < version for v in self._pins),
                timeout=self.spec.topology.barrier_timeout_s)
        write_ack(self.publish_dir, self.reader_id, version)
        self._log("replica map: " + json.dumps(dict(
            reader=self.reader_id, pid=os.getpid(), version=version,
            start=t0, restore_s=t1 - t0, prepare_s=t2 - t1, warm_s=t3 - t2,
            acked=time.monotonic())))

    def _answer_snap(self, snap, qs: np.ndarray, qt: np.ndarray
                     ) -> np.ndarray:
        from repro_torch.core.query import batched_query
        d = batched_query(snap.graph, snap.labelling,
                          torch.from_numpy(qs).to(self.device),
                          torch.from_numpy(qt).to(self.device),
                          plan=snap.plan)
        return d.cpu().numpy()   # waits for the microbatch

    @contextlib.contextmanager
    def _pinned(self):
        """The current snapshot, counted as in flight until the block
        (answer and send) ends."""
        with self._pins_cv:
            snap = self._snap
            self._pins[snap.version] = self._pins.get(snap.version, 0) + 1
        try:
            yield snap
        finally:
            with self._pins_cv:
                self._pins[snap.version] -= 1
                if not self._pins[snap.version]:
                    del self._pins[snap.version]
                self._pins_cv.notify_all()

    def answer(self, qs: np.ndarray, qt: np.ndarray, snap=None
               ) -> tuple[np.ndarray, int]:
        if snap is None:
            snap = self._snap  # one load: consistent snapshot for the batch
        m = qs.shape[0]
        # Pad to the nearest warmed bucket with copies of query 0 (an
        # oversized ad-hoc batch runs at its own width).
        width = next((w for w in self._buckets() if w >= m), m)
        idx = np.concatenate([np.arange(m, dtype=np.int64),
                              np.zeros(width - m, np.int64)])
        d = self._answer_snap(snap, qs[idx], qt[idx])
        return d[:m], snap.version

    # -- polling + serving --------------------------------------------------

    def _poll_loop(self) -> None:
        poll_s = self.spec.topology.poll_ms / 1e3
        while self.running:
            try:
                cur = ckpt.current_step(self.publish_dir)
                if cur is not None and (self._snap is None
                                        or cur != self._snap.version):
                    self._map_version(cur)
            except FileNotFoundError:
                pass  # pointer mid-prune race; next poll settles it
            time.sleep(poll_s)

    def _client_loop(self, conn: socket.socket) -> None:
        try:
            with conn:
                while self.running:
                    kind, payload = recv_msg(conn)
                    if kind == MSG_QUERY:
                        qs, qt = unpack_query(payload)
                        t0 = time.monotonic()
                        with self._pinned() as snap:
                            d, version = self.answer(qs, qt, snap)
                            send_msg(conn, MSG_ANSWER,
                                     pack_answer(version, version, d))
                        self._batches.append(
                            (t0, len(qs), time.monotonic() - t0))
                    elif kind == MSG_PING:
                        v = self._snap.version if self._snap else -1
                        send_msg(conn, MSG_PONG, struct.pack("<q", v))
                    elif kind == MSG_STOP:
                        self.running = False
                        return
        except (ConnectionError, OSError):
            return

    def serve_forever(self) -> None:
        host = self.spec.topology.host
        # Map the first published version before accepting queries.
        deadline = time.monotonic() + 120.0
        self._build_engine()
        while True:
            cur = ckpt.current_step(self.publish_dir)
            if cur is not None:
                write_ack(self.publish_dir, self.reader_id, cur - 1)
                self._map_version(cur)
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"reader {self.reader_id}: no CURRENT under "
                    f"{self.publish_dir} after 120s")
            time.sleep(0.05)
        poller = threading.Thread(target=self._poll_loop, daemon=True)
        poller.start()
        try:
            with socket.create_server((host, self.port)) as srv:
                srv.settimeout(0.25)
                print(f"reader {self.reader_id}: serving "
                      f"v{self._snap.version} on {host}:{self.port} "
                      f"[{self.device}]", flush=True)
                while self.running:
                    try:
                        conn, _ = srv.accept()
                    except socket.timeout:
                        continue
                    threading.Thread(target=self._client_loop,
                                     args=(conn,), daemon=True).start()
        finally:
            # Let a map in flight finish before the process exits, so no
            # device work is cut at interpreter shutdown.
            self.running = False
            poller.join(timeout=5.0)
            self._log("replica batches: " + json.dumps(dict(
                reader=self.reader_id, pid=os.getpid(),
                batches=list(self._batches))))


def reader_main(spec, publish_dir: str, port: int, reader_id: int,
                device=None) -> None:
    _ReaderServer(spec, publish_dir, port, reader_id,
                  device).serve_forever()


# ---------------------------------------------------------------------------
# Router role
# ---------------------------------------------------------------------------

class _Entry:
    """One admitted client request awaiting its coalesced dispatch."""
    __slots__ = ("sock", "lock", "qs", "qt", "t_arrival")

    def __init__(self, sock, lock, qs, qt):
        self.sock, self.lock = sock, lock
        self.qs, self.qt = qs, qt
        self.t_arrival = time.monotonic()


class Router:
    """Admission control + coalescing + reader health, one thread per
    reader endpoint (each pulls a batch when its reader is free — load
    balancing falls out of the pull loop, no placement policy needed)."""

    def __init__(self, spec, publish_dir: str, port: int,
                 reader_addrs: list[tuple[str, int]]):
        topo = spec.topology
        self.spec = spec
        self.publish_dir = publish_dir
        self.port = port
        self.reader_addrs = reader_addrs
        self.queue = QueryQueue(topo.max_queue, spec.stream.microbatch,
                                topo.coalesce_ms / 1e3)
        self.running = True
        self._head = -1
        self._head_at = 0.0
        self._stats_lock = threading.Lock()
        # Query-denominated counters. Admission refusals are owned by
        # the queue (`QueryQueue.rejected`) — the stats doc reads them
        # from there so the count has exactly one owner; `oversized`
        # covers requests refused before they ever reach the queue.
        self.stats = {
            "answered": 0, "oversized": 0, "requeued": 0,
            "per_reader": {i: 0 for i in range(len(reader_addrs))},
            "reader_errors": {i: 0 for i in range(len(reader_addrs))},
            "staleness": {},  # lag -> answer count
        }

    # -- head-version cache (staleness accounting) --------------------------

    def head(self) -> int:
        now = time.monotonic()
        if now - self._head_at > self.spec.topology.poll_ms / 1e3:
            cur = ckpt.current_step(self.publish_dir)
            if cur is not None:
                self._head = cur
            self._head_at = now
        return self._head

    # -- client side --------------------------------------------------------

    def _client_loop(self, conn: socket.socket) -> None:
        lock = threading.Lock()
        try:
            with conn:
                while self.running:
                    kind, payload = recv_msg(conn)
                    if kind == MSG_QUERY:
                        qs, qt = unpack_query(payload)
                        if qs.size > self.spec.stream.microbatch:
                            with self._stats_lock:
                                self.stats["oversized"] += int(qs.size)
                            with lock:
                                send_msg(conn, MSG_REJECT,
                                         b"request larger than microbatch")
                            continue
                        entry = _Entry(conn, lock, qs, qt)
                        if not self.queue.offer(entry, qs.size):
                            # `offer` already counted the refusal in
                            # queue.rejected.
                            with lock:
                                send_msg(conn, MSG_REJECT, b"overloaded")
                    elif kind == MSG_STATS:
                        with self._stats_lock:
                            doc = json.dumps(
                                {**self.stats,
                                 "rejected": self.queue.rejected,
                                 "pending": self.queue.pending,
                                 "head": self.head()})
                        send_msg(conn, MSG_STATS, doc.encode())
                    elif kind == MSG_STOP:
                        self.running = False
                        return
        except (ConnectionError, OSError):
            return

    # -- reader side --------------------------------------------------------

    def _dispatch_loop(self, ridx: int) -> None:
        addr = self.reader_addrs[ridx]
        sock = None
        backoff = 0.05
        while self.running:
            if sock is None:
                try:
                    sock = socket.create_connection(addr, timeout=5.0)
                    sock.settimeout(30.0)
                    backoff = 0.05
                except OSError:
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 1.0)
                    continue
            batch = self.queue.take(timeout=0.05)
            if not batch:
                continue
            qs = np.concatenate([e.qs for e in batch])
            qt = np.concatenate([e.qt for e in batch])
            try:
                send_msg(sock, MSG_QUERY, pack_query(qs, qt))
                kind, payload = recv_msg(sock)
                if kind != MSG_ANSWER:
                    raise ConnectionError(f"unexpected reply kind {kind}")
            except (ConnectionError, OSError, socket.timeout):
                # Reader down: reclaim the batch for the healthy readers
                # (reads are idempotent — retry is safe), drop the
                # connection, and go back to reconnecting.
                try:
                    if sock is not None:
                        sock.close()
                finally:
                    sock = None
                # Re-offer before counting: whoever reads a non-zero
                # `requeued` under the stats lock also finds the
                # reclaimed queries back in the queue.
                for e in reversed(batch):
                    self.queue.offer(e, e.qs.size, front=True)
                with self._stats_lock:
                    self.stats["reader_errors"][ridx] += 1
                    # Queries, not entries — every other counter in this
                    # dict is query-denominated.
                    self.stats["requeued"] += int(qs.size)
                continue
            version, _, d = unpack_answer(payload)
            head = max(self.head(), version)
            off = 0
            for e in batch:
                m = e.qs.size
                try:
                    with e.lock:
                        send_msg(e.sock, MSG_ANSWER,
                                 pack_answer(version, head,
                                             d[off:off + m]))
                except (ConnectionError, OSError):
                    pass  # client went away; the answer dies with it
                off += m
            with self._stats_lock:
                self.stats["answered"] += int(qs.size)
                self.stats["per_reader"][ridx] += int(qs.size)
                lag = str(head - version)
                self.stats["staleness"][lag] = \
                    self.stats["staleness"].get(lag, 0) + int(qs.size)

    def serve_forever(self) -> None:
        for ridx in range(len(self.reader_addrs)):
            threading.Thread(target=self._dispatch_loop, args=(ridx,),
                             daemon=True).start()
        with socket.create_server((self.spec.topology.host,
                                   self.port)) as srv:
            srv.settimeout(0.25)
            print(f"router: {len(self.reader_addrs)} readers on "
                  f"{self.spec.topology.host}:{self.port}", flush=True)
            while self.running:
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                threading.Thread(target=self._client_loop, args=(conn,),
                                 daemon=True).start()


def router_main(spec, publish_dir: str, port: int,
                reader_addrs: list[tuple[str, int]]) -> None:
    Router(spec, publish_dir, port, reader_addrs).serve_forever()


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class RejectedError(RuntimeError):
    """The router refused the request (admission control / overload)."""


class RouterClient:
    """Synchronous client of one router connection (thread-unsafe; use
    one per worker thread)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)

    def query(self, qs, qt) -> tuple[np.ndarray, int, int]:
        """Answer a batch → (distances, version, head). Raises
        `RejectedError` when admission control refuses it."""
        send_msg(self.sock, MSG_QUERY, pack_query(qs, qt))
        kind, payload = recv_msg(self.sock)
        if kind == MSG_REJECT:
            raise RejectedError(payload.decode())
        version, head, d = unpack_answer(payload)
        return d, version, head

    def stats(self) -> dict:
        send_msg(self.sock, MSG_STATS)
        kind, payload = recv_msg(self.sock)
        return json.loads(payload.decode())

    def stop_peer(self) -> None:
        try:
            send_msg(self.sock, MSG_STOP)
        except OSError:
            pass

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Orchestrator: spawn + supervise the topology, drive the client stream
# ---------------------------------------------------------------------------

def free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _role_env() -> dict:
    src = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


@dataclasses.dataclass
class AnswerRecord:
    """One answered client query, with its serving version + staleness."""
    qs: int
    qt: int
    answer: int
    version: int
    staleness: int
    latency_s: float
    #: `time.monotonic()` at its arrival (the same clock in every process)
    arrival: float = 0.0


@dataclasses.dataclass
class ReplicaReport:
    """What one topology run produced (benches + tests consume this)."""
    answers: list[AnswerRecord]
    rejected: int
    router_stats: dict
    reader_restarts: int
    #: queries the stream sent (answered + rejected, unless one was lost)
    offered: int = 0

    def latency_percentiles(self) -> dict[str, float]:
        lat = np.asarray([a.latency_s for a in self.answers])
        if lat.size == 0:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {p: float(np.percentile(lat, q))
                for p, q in (("p50", 50), ("p95", 95), ("p99", 99))}

    def max_staleness(self) -> int:
        return max((a.staleness for a in self.answers), default=0)


class ReplicaTopology:
    """Spawn and supervise 1 updater + N readers + 1 router.

    `watch()` is the crash detector: a reader process that died is
    relaunched (same id, same port) when the topology was configured
    with `restart`; the new process re-maps from ``CURRENT`` and the
    router's dispatch loop reconnects on its own. The updater is never
    restarted implicitly — it is the single writer, and a half-done
    update must resume through ``--resume`` semantics deliberately.

    `device` is passed to every role as ``--device`` (None: each role
    resolves the GPU and raises without one). With `log_dir`, each
    role's output and errors go to ``<log_dir>/<role>.log`` (appended
    across a reader's restarts) instead of this process's streams.
    """

    def __init__(self, spec, publish_dir: str, device=None,
                 log_dir: str | None = None):
        self.spec = spec
        self.publish_dir = publish_dir
        self.device = None if device is None else str(device)
        self.log_dir = log_dir
        self.config_path = os.path.join(publish_dir, "config.json")
        topo = spec.topology
        self.router_port = topo.router_port or free_port(topo.host)
        self.reader_ports = [
            (topo.reader_port0 + k) if topo.reader_port0 else
            free_port(topo.host) for k in range(topo.readers)]
        self.updater: subprocess.Popen | None = None
        self.router: subprocess.Popen | None = None
        self.readers: list[subprocess.Popen | None] = \
            [None] * topo.readers
        #: `time.monotonic()` at each reader's latest spawn
        self.reader_spawned = [0.0] * topo.readers
        self.reader_restarts = 0

    def _spawn(self, role: str, *extra: str, log: str | None = None
               ) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "repro_torch.launch.replica",
               "--role", role, "--config", self.config_path,
               "--publish-dir", self.publish_dir, *extra]
        if self.device is not None:
            cmd += ["--device", self.device]
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            with open(os.path.join(self.log_dir, f"{log or role}.log"),
                      "ab") as fh:
                return subprocess.Popen(cmd, env=_role_env(), stdout=fh,
                                        stderr=subprocess.STDOUT)
        # quiet topologies (benchmarks) keep role chatter off the CSV
        # stream; stderr stays inherited so failures surface.
        out = subprocess.DEVNULL if self.spec.stream.quiet else None
        return subprocess.Popen(cmd, env=_role_env(), stdout=out)

    def start_reader(self, k: int) -> None:
        self.reader_spawned[k] = time.monotonic()
        self.readers[k] = self._spawn(
            "reader", "--reader-id", str(k),
            "--port", str(self.reader_ports[k]), log=f"reader_{k}")

    def _exited_role(self) -> str | None:
        """A role that has exited during start-up: the updater with an
        error (a short run may finish), any reader or the router."""
        if self.updater.poll() not in (None, 0):
            return f"updater exited rc={self.updater.returncode}"
        for k, p in enumerate(self.readers):
            if p.poll() is not None:
                return f"reader {k} exited rc={p.returncode}"
        if self.router.poll() is not None:
            return f"router exited rc={self.router.returncode}"
        return None

    def start(self, timeout_s: float = 180.0) -> None:
        os.makedirs(self.publish_dir, exist_ok=True)
        self.spec.save_json(self.config_path)
        self.updater = self._spawn("updater")
        for k in range(self.spec.topology.readers):
            self.start_reader(k)
        addrs = ",".join(f"{self.spec.topology.host}:{p}"
                         for p in self.reader_ports)
        self.router = self._spawn("router", "--port",
                                  str(self.router_port),
                                  "--reader-addrs", addrs)
        # Ready when the router accepts and a reader answers a probe
        # end-to-end (implies CURRENT exists and a snapshot is mapped).
        deadline = time.monotonic() + timeout_s
        while True:
            exited = self._exited_role()
            if exited is not None:
                raise RuntimeError(f"{exited} during startup")
            try:
                c = RouterClient(self.spec.topology.host,
                                 self.router_port, timeout=5.0)
                d, _, _ = c.query(np.zeros(1, np.int32),
                                  np.zeros(1, np.int32))
                c.close()
                if d.shape == (1,):
                    return
            except (OSError, RejectedError):
                pass
            if time.monotonic() > deadline:
                raise TimeoutError("replica topology not ready in "
                                   f"{timeout_s:.0f}s")
            time.sleep(0.2)

    def client(self, timeout: float = 30.0) -> RouterClient:
        return RouterClient(self.spec.topology.host, self.router_port,
                            timeout=timeout)

    def kill_reader(self, k: int) -> None:
        p = self.readers[k]
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()

    def watch(self) -> None:
        """Crash detection: restart dead readers (when configured)."""
        for k, p in enumerate(self.readers):
            if p is not None and p.poll() is not None \
                    and self.spec.topology.restart:
                self.reader_restarts += 1
                self.start_reader(k)

    def updater_running(self) -> bool:
        return self.updater is not None and self.updater.poll() is None

    def updater_ok(self) -> bool:
        rc = None if self.updater is None else self.updater.poll()
        return rc in (None, 0)

    def stop(self) -> None:
        for p in [self.router, *self.readers, self.updater]:
            if p is not None and p.poll() is None:
                p.terminate()
        for p in [self.router, *self.readers, self.updater]:
            if p is not None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


def stream_queries(spec, topology: ReplicaTopology, total: int,
                   qps: float, workers: int = 4, on_tick=None,
                   until=None) -> ReplicaReport:
    """Drive an open-loop Poisson client stream through the router.

    `workers` concurrent connections pull from one arrival schedule —
    each query is sent as its own request (m=1), so the router's
    coalescing (not the client) is what builds reader microbatches.
    Latency is arrival → answered, the `ServeLoop` convention. The
    stream offers `total` queries, or fewer if `until()` (checked with
    `on_tick` every 0.1 s) turns true first.
    """
    n = spec.graph.realized_n()
    arr = np.random.default_rng((spec.stream.seed, 911))
    offsets = np.cumsum(arr.exponential(1.0 / qps, size=total))
    qrng = np.random.default_rng((spec.stream.seed, 912))
    qs = qrng.integers(0, n, total).astype(np.int32)
    qt = qrng.integers(0, n, total).astype(np.int32)

    answers: list[AnswerRecord] = []
    rejected = [0]
    next_idx = [0]
    lock = threading.Lock()
    done = threading.Event()
    t0 = time.monotonic()

    def worker() -> None:
        client = topology.client()
        try:
            while True:
                with lock:
                    i = next_idx[0]
                    if i >= total or done.is_set():
                        return
                    next_idx[0] += 1
                due = t0 + offsets[i]
                wait = due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                try:
                    d, version, head = client.query(qs[i:i + 1],
                                                    qt[i:i + 1])
                except RejectedError:
                    with lock:
                        rejected[0] += 1
                    continue
                rec = AnswerRecord(
                    qs=int(qs[i]), qt=int(qt[i]), answer=int(d[0]),
                    version=version, staleness=head - version,
                    latency_s=time.monotonic() - due, arrival=due)
                with lock:
                    answers.append(rec)
        finally:
            client.close()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(workers)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        topology.watch()
        if on_tick is not None:
            on_tick()
        if until is not None and until():
            done.set()
        time.sleep(0.1)
    for t in threads:
        t.join()

    stats = {}
    try:
        c = topology.client(timeout=5.0)
        stats = c.stats()
        c.close()
    except OSError:
        pass
    return ReplicaReport(answers=answers, rejected=rejected[0],
                         router_stats=stats,
                         reader_restarts=topology.reader_restarts,
                         offered=next_idx[0])


def verify_answers(publish_dir: str, answers: list[AnswerRecord],
                   limit: int | None = None) -> int:
    """Check answers against the Dijkstra oracle *at the version each
    was served* — the `ServeLoop --verify` contract across the process
    boundary. Returns the mismatch count. The oracle needs only the
    graph, so each served step is restored onto the CPU."""
    from repro_torch.core import ref
    from repro_torch.core.snapshot import restore_snapshot
    from repro_torch.graphs.coo import to_numpy_wadj

    wadj_at: dict[int, dict] = {}
    wrong = 0
    for rec in answers[:limit]:
        if rec.version not in wadj_at:
            snap = restore_snapshot(publish_dir, step=rec.version,
                                    mmap=True, device="cpu")
            wadj_at[rec.version] = to_numpy_wadj(snap.graph)
        adj = wadj_at[rec.version]
        got = float(rec.answer)
        want = ref.pair_distance_w(adj, len(adj), rec.qs, rec.qt)
        want = got if (want == ref.INF and got >= 1e8) else want
        if rec.qs == rec.qt:
            want = 0
        wrong += int(got != want)
    return wrong


def serve_main(spec, publish_dir: str, verify_limit: int | None,
               device=None) -> ReplicaReport:
    """The ``serve`` role: run the whole topology + a client stream, and
    return its report."""
    topo = ReplicaTopology(spec, publish_dir, device=device)
    total = spec.stream.queries * spec.stream.batches
    try:
        topo.start()
        report = stream_queries(spec, topo, total, spec.stream.qps)
        pct = report.latency_percentiles()
        print(f"replica serve: {len(report.answers)}/{total} answered "
              f"({report.rejected} rejected, "
              f"{report.reader_restarts} reader restarts) | "
              f"p50 {pct['p50'] * 1e3:.1f}ms p95 {pct['p95'] * 1e3:.1f}ms "
              f"p99 {pct['p99'] * 1e3:.1f}ms | "
              f"max staleness {report.max_staleness()} | "
              f"router {report.router_stats}", flush=True)
        if not topo.updater_ok():
            raise SystemExit(
                f"updater failed rc={topo.updater.returncode}")
        if report.max_staleness() > 1:
            raise SystemExit(
                f"staleness contract violated: max "
                f"{report.max_staleness()} > 1")
        if spec.stream.verify:
            wrong = verify_answers(publish_dir, report.answers,
                                   limit=verify_limit)
            checked = len(report.answers[:verify_limit])
            print(f"verify: {wrong}/{checked} mismatches", flush=True)
            if wrong:
                raise SystemExit(f"verify FAILED: {wrong} mismatches")
        return report
    finally:
        topo.stop()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def exit_record(record: dict) -> dict:
    """`record` with this process's kernel launch counts and peak device
    bytes (0 where the process never touched a CUDA device)."""
    from repro_torch.kernels.edge_relax import kernel as rk
    from repro_torch.kernels.minplus import kernel as mk
    peak = torch.cuda.max_memory_allocated() \
        if torch.cuda.is_initialized() else 0
    return {**record,
            "launches": {"relax_sweep": rk.launches, "minplus": mk.launches},
            "peak_device_bytes": int(peak)}


def main() -> None:
    ap = argparse.ArgumentParser(
        description="replica serve tier: updater / reader / router roles, "
                    "all launched from one serialized ServeSpec")
    ap.add_argument("--role", required=True,
                    choices=("updater", "reader", "router", "serve"))
    ap.add_argument("--config", default=None,
                    help="serialized ServeSpec JSON (required for "
                         "updater/reader/router; the serve role also "
                         "accepts flat flags)")
    ap.add_argument("--publish-dir", required=True,
                    help="the publish directory: step_<v> checkpoints + "
                         "the CURRENT pointer + reader acks")
    ap.add_argument("--reader-id", type=int, default=0)
    ap.add_argument("--port", type=int, default=0,
                    help="bind port of this reader/router")
    ap.add_argument("--reader-addrs", default="",
                    help="router role: comma-separated host:port of the "
                         "readers")
    ap.add_argument("--verify-limit", type=int, default=None,
                    help="serve role: oracle-check at most this many "
                         "answers (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device of the updater and the readers "
                         "(default: the GPU, raising without one; 'cpu' "
                         "runs the kernels' plain versions); the serve "
                         "role passes it on to every role it spawns")
    # The serve role accepts the full flat-flag surface too, so CI can
    # launch a topology without materializing a JSON first.
    from repro_torch.launch.config import ServeSpec, spec_from_cli
    ServeSpec.add_args(ap)
    args = ap.parse_args()

    if args.config:
        spec = ServeSpec.load_json(args.config)
    elif args.role == "serve":
        spec = spec_from_cli(args, ap)
    else:
        ap.error(f"--config is required for the {args.role} role (every "
                 "process of one deployment shares one serialized spec)")

    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
    if args.role == "serve":
        serve_main(spec, args.publish_dir, args.verify_limit, args.device)
        return
    record = {"role": args.role, "pid": os.getpid()}
    try:
        if args.role == "updater":
            updater_main(spec, args.publish_dir, args.device)
        elif args.role == "reader":
            record["reader"] = args.reader_id
            reader_main(spec, args.publish_dir, args.port, args.reader_id,
                        args.device)
        else:
            addrs = []
            for part in args.reader_addrs.split(","):
                host, _, port = part.rpartition(":")
                addrs.append((host, int(port)))
            router_main(spec, args.publish_dir, args.port, addrs)
    finally:
        print("replica exit: " + json.dumps(exit_record(record)),
              flush=True)


if __name__ == "__main__":
    main()
