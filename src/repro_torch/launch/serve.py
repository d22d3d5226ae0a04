"""BatchHL distance-query serving loop on one GPU — the system end to end.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 2000 --batches 5

The port of `repro.launch.serve`. Per tick the loop ingests one batch of
edge updates (mix set by ``--scenario``), maintains the labelling with
BatchHL, and answers an *open-loop* query stream: ``--queries`` arrivals
per tick at Poisson rate ``--qps``, dispatched in microbatches of
``--microbatch``. Two serving modes (DESIGN.md §5):

* **synchronous** (default): the whole update runs at once, and every
  query that arrives meanwhile waits for it.
* **``--pipeline``**: the update runs as bounded chunks
  (`core/snapshot.pipelined_update`, ``--chunk-sweeps`` waves each) while
  query microbatches keep running against the committed snapshot N on
  the same device stream; the commit is a version swap. A query waits for
  at most one chunk, answers are exact at the version that served them
  (staleness ≤ 1), and the final labelling equals the synchronous loop's.

The loop reports p50/p95/p99 latency from arrival to answer and the
answers' staleness; ``--verify`` checks sampled answers against the
Dijkstra oracle at the version each was answered.

Device and sweeps: ``--device`` (default: the GPU; raises without one).
``--backend auto``/``pallas`` runs every sweep through the relax-sweep
kernel on the GPU and its plain PyTorch version on the CPU, with one
`RelaxEngine` whose plan cache keeps both live snapshots' tilings;
``--backend jnp`` is the COO path (`plan=None`), on the CPU only. The
Eq.-3 bound runs the min-plus kernel on the GPU and its plain version on
the CPU, whatever ``--use-minplus-kernel`` says. ``--autotune`` measures
kernel A's launch shapes against the `sorted` impl once per snapshot shape
and serves the winner (`core/autotune.py`); ``--tune-table PATH`` keeps
the winners on disk (and implies ``--autotune``), so a restart measures
nothing.

Mesh sharding: ``--mesh host`` runs construction, updates and queries
through `core/shard.py` on a `make_host_mesh` over the local devices of
``--device`` (every card, or the one CPU); ``--shards M`` sets the
model-axis size. Landmark counts are validated against both plane
groupings (data × model for maintenance, model for queries) with an
error naming the failing one. `ServeLoop(cfg, mesh=...)` takes a
prebuilt mesh instead, whose devices may repeat (several shards on one
card, one after another).

This is one process. The replica tier (`launch/replica.py`) runs this
loop with the query stream off as its updater, publishes every version,
and answers queries from reader processes behind a router.

Checkpointing: ``--ckpt-dir`` persists the full serve state each tick
(graph slots, labelling, version, the host edge list) in the reference's
format; ``--resume`` restarts from the newest checkpoint and continues the
same stream (seeds are tick-indexed).

Grow-in-place: ``--capacity C`` starts at C edge slots; with ``--grow`` a
batch that would overflow (or that names vertex ids >= n) grows the slots
and planes geometrically at the version boundary (DESIGN.md §6); without
it the overflow raises a typed ``CapacityError`` naming the tick before
anything is dispatched.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import ref
from repro_torch.core.batch import batchhl_update
from repro_torch.core.construct import (build_labelling,
                                        select_landmarks_by_degree)
from repro_torch.core.engine import RelaxEngine
from repro_torch.core.growth import GrowthEvent, GrowthPolicy, ensure_capacity
from repro_torch.core.query import batched_query
from repro_torch.core.shard import (shard_batched_query, shard_batchhl_update,
                                    shard_build_labelling,
                                    validate_landmark_sharding)
from repro_torch.core.snapshot import (Snapshot, SnapshotStore,
                                       pipelined_update, restore_extra,
                                       restore_snapshot, save_snapshot)
from repro_torch.data.scenarios import get_scenario
from repro_torch.device import resolve_device
from repro_torch.graphs import generators as gen
from repro_torch.graphs.coo import (apply_batch, from_edges, make_batch,
                                    to_numpy_wadj)
from repro_torch.launch.mesh import Mesh, make_host_mesh


class EdgeSet:
    """The host edge set in serve order.

    Rows (u, v, w) with u < v in a numpy array grown by doubling, a dict
    from (u, v) to its row, swap-remove on delete: each tick costs
    O(batch), and the batch sampler and a checkpoint read the rows
    without a conversion. The order is serve state (deletion sampling
    depends on it), so it rides along in every checkpoint; it is the
    reference loop's list order exactly.
    """

    def __init__(self, edges: np.ndarray):
        edges = np.asarray(edges)
        count = len(edges)
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        self.rows = np.zeros((max(16, 2 * count), 3), np.int32)
        self.rows[:count, 0], self.rows[:count, 1] = lo, hi
        self.rows[:count, 2] = edges[:, 2] if edges.shape[1] > 2 else 1
        self.count = count
        self.pos: dict[tuple[int, int], int] = dict(
            zip(zip(lo.tolist(), hi.tolist()), range(count)))

    def edges(self) -> np.ndarray:
        """The rows in serve order, [E, 3] (a view)."""
        return self.rows[:self.count]

    def apply(self, ups) -> None:
        """Fold a tick's updates (op 0 insert, 1 delete, 2 re-weight)."""
        for up in ups:
            u, v, op = up[0], up[1], int(up[2])
            w = int(up[3]) if len(up) > 3 else 1
            k = (min(u, v), max(u, v))
            if op == 1:
                i = self.pos.pop(k, None)
                if i is not None:
                    self.count -= 1
                    if i < self.count:
                        self.rows[i] = self.rows[self.count]
                        lo, hi = self.rows[i, :2].tolist()
                        self.pos[lo, hi] = i
            elif op == 2:
                if k in self.pos:
                    self.rows[self.pos[k], 2] = w
            elif k not in self.pos:
                if self.count == len(self.rows):
                    self.rows = np.concatenate(
                        [self.rows, np.zeros_like(self.rows)])
                self.rows[self.count] = (k[0], k[1], w)
                self.pos[k] = self.count
                self.count += 1


@dataclasses.dataclass
class ServeConfig:
    """Everything the serving loop needs; `main()` maps CLI flags here.

    The fields are the reference's, so a `ServeSpec` written by either
    package loads in the other.
    """
    n: int = 2000
    deg: int = 4
    #: initial graph family: "ba" (power-law, unit weights) or "road"
    #: (weighted planar grid). Road rounds n up to the grid's rows·cols.
    graph: str = "ba"
    landmarks: int = 16
    batches: int = 5
    batch_size: int = 100
    scenario: str = "mixed"
    # open-loop query stream
    queries: int = 256          # arrivals per tick
    qps: float = 2000.0         # Poisson arrival rate (queries/second)
    microbatch: int = 32        # max queries per dispatched microbatch
    # serving mode
    pipeline: bool = False
    chunk_sweeps: int = 1       # relaxation waves per pipelined chunk
    # engine
    backend: str = "auto"       # auto/pallas: the kernels; jnp: COO path
    block_v: int = 512
    tile_shards: int = 1
    block_e: int | None = None   # tile-row width cap of the tiling
    use_minplus_kernel: bool = False  # kernel on the GPU regardless
    mesh: str = "none"           # "host": shard on make_host_mesh
    shards: int = 1              # model-axis size of the host mesh
    autotune: bool = False       # tune impl + tile shape per snapshot shape
    tune_table: str | None = None  # on-disk tuning table (core/autotune.py)
    fused: bool = False          # fused pipelined chunks (snapshot.py)
    # frontier-proportional sweeps (DESIGN.md §10)
    frontier: bool = False
    frontier_threshold: float = 0.25
    # capacity / grow-in-place (DESIGN.md §6)
    capacity: int | None = None  # initial edge capacity (None = provision
                                 # for the scenario's worst-case inserts)
    grow: bool = False           # grow on overflow instead of raising
    growth_factor: float = 2.0
    # ops
    verify: bool = False
    ckpt_dir: str | None = None
    resume: bool = False
    seed: int = 7
    quiet: bool = False
    #: retain every committed snapshot in the report (lets a caller
    #: recompute any answer at its version)
    keep_history: bool = False


@dataclasses.dataclass
class MicrobatchRecord:
    """One answered microbatch: which queries, at which version."""
    tick: int
    version: int                # snapshot version the answers are exact at
    staleness: int              # versions behind the in-flight head
    qs: np.ndarray              # int32 [m] (unpadded)
    qt: np.ndarray
    answers: np.ndarray         # int32 [m]
    latencies: np.ndarray       # float64 [m] seconds, arrival → answered


@dataclasses.dataclass
class TickStats:
    tick: int
    version: int                # committed version after this tick
    update_s: float             # dispatch start → commit
    affected: int
    label_size: int
    queries: int
    verify_mismatches: int | None = None
    grew: bool = False          # this tick grew capacity/planes (§6)
    capacity: int = 0           # edge capacity after this tick
    graph_n: int = 0            # vertex slots after this tick
    ckpt_s: float = 0.0         # seconds to save this tick's checkpoint


@dataclasses.dataclass
class ServeReport:
    """Everything a caller (benchmarks, tests) needs from one run."""
    config: ServeConfig
    ticks: list[TickStats]
    microbatches: list[MicrobatchRecord]
    final: Snapshot
    backend: str
    #: version -> committed Snapshot, populated when keep_history is set
    history: dict[int, Snapshot] = dataclasses.field(default_factory=dict)
    #: grow-in-place events, in tick order (empty without --grow)
    growth: list[GrowthEvent] = dataclasses.field(default_factory=list)

    def latencies(self) -> np.ndarray:
        if not self.microbatches:
            return np.zeros((0,))
        return np.concatenate([m.latencies for m in self.microbatches])

    def latency_percentiles(self) -> dict[str, float]:
        lat = self.latencies()
        if lat.size == 0:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {p: float(np.percentile(lat, q))
                for p, q in (("p50", 50), ("p95", 95), ("p99", 99))}

    def staleness(self) -> np.ndarray:
        return np.concatenate(
            [np.full(m.latencies.shape, m.staleness, np.int32)
             for m in self.microbatches]) if self.microbatches else \
            np.zeros((0,), np.int32)

    def mean_staleness(self) -> float:
        s = self.staleness()
        return float(s.mean()) if s.size else 0.0


def serve_engine(cfg: ServeConfig,
                 device: torch.device) -> RelaxEngine | None:
    """The relaxation engine a serve process runs on `device`, or None for
    the COO path (`backend="jnp"`). The serve loop, the replica tier's
    updater (through the loop) and its readers all build theirs here.

    Raises for a setting the port does not run: an unknown backend or
    mesh, and the COO path on the GPU, where it would bypass the kernel.
    """
    if cfg.backend not in ("auto", "jnp", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}; pick from "
                         "('auto', 'jnp', 'pallas')")
    if cfg.mesh not in ("none", "host"):
        raise ValueError(f"unknown mesh {cfg.mesh!r}; pick from "
                         "('none', 'host')")
    if cfg.backend == "jnp":
        # The COO path stands in for the reference's jnp backend.
        if device.type != "cpu":
            raise ValueError(
                "backend 'jnp' (the COO path, plan=None) runs on the "
                "CPU only; on the GPU every sweep goes through the "
                "relax-sweep kernel (backend 'auto' or 'pallas')")
        if cfg.frontier:
            raise ValueError("the frontier mode needs the tiled engine "
                             "(backend 'auto' or 'pallas')")
        return None
    return RelaxEngine(block_v=cfg.block_v, block_e=cfg.block_e,
                       shards=cfg.tile_shards, frontier=cfg.frontier,
                       frontier_threshold=cfg.frontier_threshold,
                       autotune=cfg.autotune, tune_table=cfg.tune_table,
                       device=device)


class ServeLoop:
    """The serving pipeline: one instance owns the engine, the snapshot
    store, the scenario streams and the open-loop query clock.

    `device=None` is the GPU and raises without one; tests pass "cpu".
    With `cfg.mesh == "host"` it shards on `make_host_mesh(cfg.shards)`
    over the local devices of `device`, or on `mesh` when given (its
    model axis must be `cfg.shards`; `device` defaults to its first
    device, where the graph and the gathered labelling live).
    """

    def __init__(self, cfg: ServeConfig,
                 device: str | torch.device | None = None,
                 mesh: Mesh | None = None):
        self.cfg = cfg
        #: optional process hooks: `on_start(snap0)` fires once the
        #: initial snapshot is in the store, before any tick;
        #: `on_commit(tick, snap)` after each tick's commit and checkpoint.
        self.on_start = None
        self.on_commit = None
        self.scenario = get_scenario(cfg.scenario)
        if cfg.graph not in ("ba", "road"):
            raise ValueError(f"unknown graph family {cfg.graph!r}; "
                             f"choose 'ba' or 'road'")
        if mesh is not None and device is None:
            device = mesh.first
        self.device = resolve_device(device)
        if cfg.graph == "road":
            # The grid realises rows·cols >= n vertices; queries, update
            # sampling and landmarks must agree on that count.
            rows = max(2, int(math.isqrt(cfg.n)))
            cols = max(2, (cfg.n + rows - 1) // rows)
            cfg.n = rows * cols
        self.engine = serve_engine(cfg, self.device)
        self.mesh = self._make_mesh(mesh)
        self.backend = "coo" if self.engine is None else (
            "cuda" if self.device.type == "cuda" else "plain")
        self.store: SnapshotStore | None = None
        self.report: ServeReport | None = None
        self.edge_set: EdgeSet | None = None
        self._oracle_adj: dict[int, dict] = {}  # version -> adjacency

    def _make_mesh(self, mesh: Mesh | None) -> Mesh | None:
        cfg = self.cfg
        if cfg.mesh == "none":
            if mesh is not None:
                raise ValueError("a mesh was given but cfg.mesh is 'none'")
            return None
        if mesh is None:
            mesh = make_host_mesh(model=cfg.shards, device=self.device)
        elif mesh.shape["model"] != cfg.shards:
            raise ValueError(f"the mesh's model axis is "
                             f"{mesh.shape['model']}, cfg.shards is "
                             f"{cfg.shards}")
        if mesh.first != self.device:
            raise ValueError(f"the mesh's first device {mesh.first} is not "
                             f"the loop's device {self.device}")
        validate_landmark_sharding(mesh, cfg.landmarks)
        return mesh

    def _mesh_desc(self) -> str:
        if self.mesh is None:
            return "unsharded"
        return (f"mesh data={self.mesh.shape['data']} "
                f"model={self.mesh.shape['model']}")

    @property
    def growth_policy(self) -> GrowthPolicy:
        """Grow-in-place policy aligned to the tiling unit block_v ·
        shards, on every backend, so a growth stream reaches the same
        sizes whichever backend serves it. The unit is read from the
        engine at each use: an adopted autotuned kernel winner changes its
        block_v, and grown vertex counts must follow the tiles actually
        served. The COO path has no engine and keeps the config's."""
        if self.engine is None:
            return GrowthPolicy(factor=self.cfg.growth_factor,
                                block_v=self.cfg.block_v,
                                shards=self.cfg.tile_shards)
        return GrowthPolicy(factor=self.cfg.growth_factor,
                            block_v=self.engine.block_v,
                            shards=self.engine.shards)

    def _log(self, msg: str) -> None:
        if not self.cfg.quiet:
            print(msg, flush=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prepare(self, g, topology_changed: bool = True):
        if self.engine is None:
            return None
        return self.engine.prepare(g, topology_changed=topology_changed)

    # -- setup --------------------------------------------------------------

    def _fresh_snapshot(self) -> Snapshot:
        cfg = self.cfg
        if cfg.graph == "road":
            edges = gen.road_grid(cfg.n, max_weight=max(
                2, self.scenario.max_weight), seed=0)
        else:
            edges = gen.barabasi_albert(cfg.n, cfg.deg, seed=0)
        cap = cfg.capacity if cfg.capacity is not None else (
            edges.shape[0]
            + self.scenario.max_inserts(cfg.batches, cfg.batch_size) + 64)
        g = from_edges(cfg.n, edges, cap, device=self.device)
        landmarks = select_landmarks_by_degree(g, cfg.landmarks)
        plan = self._prepare(g)
        t0 = time.time()
        if self.mesh is not None:
            lab = shard_build_labelling(self.mesh, g, landmarks, plan=plan)
        else:
            lab = build_labelling(g, landmarks, plan=plan)
        self._sync()
        self.edge_set = EdgeSet(edges)
        self._log(f"constructed labelling: {cfg.n} vertices, "
                  f"{edges.shape[0]} edges, R={cfg.landmarks}, "
                  f"size={int(lab.label_size())}, {time.time() - t0:.2f}s "
                  f"[backend={self.backend}, {self.device}, "
                  f"{self._mesh_desc()}]")
        return Snapshot(0, g, lab, plan)

    def _resumed_snapshot(self) -> Snapshot:
        cfg = self.cfg
        snap = restore_snapshot(cfg.ckpt_dir, device=self.device)
        # A grown run checkpoints n >= cfg.n, so the graph's own n cannot
        # tell "this config, grown" from "a larger config": each
        # checkpoint carries the run's base n, which must match.
        try:
            base_n = int(restore_extra(cfg.ckpt_dir,
                                       ("base_n",))["base_n"])
        except FileNotFoundError:
            base_n = snap.graph.n
        if base_n != cfg.n:
            raise ValueError(
                f"checkpoint is from a run with n={base_n} "
                f"(grown to {snap.graph.n}), config has n={cfg.n}")
        edge_arr = restore_extra(cfg.ckpt_dir, ("edge_list",))["edge_list"]
        self.edge_set = EdgeSet(edge_arr)
        snap = dataclasses.replace(snap, plan=self._prepare(snap.graph))
        self._log(f"resumed at version {snap.version}: {cfg.n} vertices, "
                  f"{self.edge_set.count} edges, "
                  f"size={int(snap.labelling.label_size())} "
                  f"[backend={self.backend}, {self.device}, "
                  f"{self._mesh_desc()}]")
        return snap

    # -- query stream -------------------------------------------------------

    def _tick_queries(self, tick: int) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
        """This tick's open-loop stream: (offsets [Q] s, qs [Q], qt [Q]).

        Content and arrival offsets are pure functions of (seed, tick), so
        sync, pipelined and resumed runs see the same stream; only *when*
        each query is answered differs.
        """
        cfg = self.cfg
        arr_rng = np.random.default_rng((cfg.seed, 101, tick))
        offsets = np.cumsum(
            arr_rng.exponential(1.0 / cfg.qps, size=cfg.queries))
        q_rng = np.random.default_rng((cfg.seed, 202, tick))
        qs, qt = self.scenario.sample_queries(q_rng, cfg.n, cfg.queries)
        return offsets, qs, qt

    def _answer(self, snap: Snapshot, qs: np.ndarray,
                qt: np.ndarray) -> np.ndarray:
        qs, qt = (torch.from_numpy(x).to(self.device) for x in (qs, qt))
        if self.mesh is None:
            d = batched_query(snap.graph, snap.labelling, qs, qt,
                              plan=snap.plan)
        else:
            d = shard_batched_query(self.mesh, snap.graph, snap.labelling,
                                    qs, qt, plan=snap.plan)
        return d.cpu().numpy()   # waits for the microbatch

    def _drain_arrived(self, tick: int, tick_t0: float, offsets: np.ndarray,
                       qs: np.ndarray, qt: np.ndarray, served: int,
                       head_version: int,
                       out: list[MicrobatchRecord]) -> int:
        """Answer every query that has arrived by now, in microbatches of
        at most cfg.microbatch, against the committed snapshot. Returns
        the new served count."""
        cfg = self.cfg
        q = offsets.shape[0]
        while served < q:
            arrived = int(np.searchsorted(offsets, time.time() - tick_t0,
                                          side="right"))
            if arrived <= served:
                break
            take = min(cfg.microbatch, arrived - served)
            idx = np.arange(served, served + take)
            # Pad to the fixed microbatch shape by repeating the first
            # query; the pad lanes are dropped from the record.
            pad_idx = np.concatenate(
                [idx, np.full(cfg.microbatch - take, idx[0])])
            snap = self.store.committed
            d = self._answer(snap, qs[pad_idx], qt[pad_idx])
            t_done = time.time()
            out.append(MicrobatchRecord(
                tick=tick, version=snap.version,
                staleness=head_version - snap.version,
                qs=qs[idx].copy(), qt=qt[idx].copy(),
                answers=d[:take].copy(),
                latencies=t_done - (tick_t0 + offsets[idx])))
            served += take
        return served

    def _drain_rest(self, tick: int, tick_t0: float, offsets: np.ndarray,
                    qs: np.ndarray, qt: np.ndarray, served: int,
                    head_version: int, out: list[MicrobatchRecord]) -> int:
        """Serve the tick's remaining arrivals, sleeping the open-loop
        clock forward between stragglers."""
        q = offsets.shape[0]
        while served < q:
            wait = tick_t0 + offsets[served] - time.time()
            if wait > 0:
                time.sleep(wait)
            served = self._drain_arrived(tick, tick_t0, offsets, qs, qt,
                                         served, head_version, out)
        return served

    # -- update modes -------------------------------------------------------

    def _update_sync(self, snap: Snapshot, batch, plan, g_next) -> Snapshot:
        """The whole update at once; queries wait behind it."""
        if self.mesh is None:
            g2, lab2, aff = batchhl_update(snap.graph, batch, snap.labelling,
                                           improved=True, plan=plan,
                                           g_new=g_next)
        else:
            g2, lab2, aff = shard_batchhl_update(self.mesh, snap.graph,
                                                 batch, snap.labelling,
                                                 improved=True, plan=plan,
                                                 g_new=g_next)
        self._sync()
        self._last_aff = aff
        return Snapshot(snap.version + 1, g2, lab2, plan)

    def _update_pipelined(self, snap: Snapshot, batch, plan, g_next,
                          tick: int, tick_t0: float, offsets, qs, qt,
                          served_box: list, out) -> Snapshot:
        """The chunked update: serve arrived microbatches at every yield."""
        cfg = self.cfg
        upd = pipelined_update(snap, batch, plan=plan, g_new=g_next,
                               mesh=self.mesh, improved=True,
                               chunk_sweeps=cfg.chunk_sweeps,
                               fused=cfg.fused)
        head = snap.version + 1
        while True:
            try:
                next(upd)
            except StopIteration as stop:
                nxt, aff = stop.value
                break
            served_box[0] = self._drain_arrived(
                tick, tick_t0, offsets, qs, qt, served_box[0], head, out)
        self._sync()
        self._last_aff = aff
        return nxt

    # -- verification -------------------------------------------------------

    def _oracle(self, version: int, graph) -> dict:
        if version not in self._oracle_adj:
            self._oracle_adj[version] = to_numpy_wadj(graph)
            # A tick verifies against its own two versions only.
            for old in [v for v in self._oracle_adj if v < version - 1]:
                del self._oracle_adj[old]
        return self._oracle_adj[version]

    def _verify_tick(self, tick: int, out: list[MicrobatchRecord],
                     snapshots: dict[int, Snapshot]) -> int:
        """Check the first min(64, Q) answered queries of the tick against
        the Dijkstra oracle at the version each was answered."""
        n_check = min(64, self.cfg.queries)
        wrong = checked = 0
        for m in out:
            if m.tick != tick or checked >= n_check:
                continue
            adj = self._oracle(m.version, snapshots[m.version].graph)
            for i in range(m.qs.shape[0]):
                if checked >= n_check:
                    break
                got = float(m.answers[i])
                # len(adj) is the snapshot's own n (a grown one has more
                # vertices than cfg.n).
                want = ref.pair_distance_w(adj, len(adj), int(m.qs[i]),
                                           int(m.qt[i]))
                want = got if (want == ref.INF and got >= 1e8) else want
                if int(m.qs[i]) == int(m.qt[i]):
                    want = 0
                wrong += int(got != want)
                checked += 1
        self._log(f"  verify: {wrong}/{n_check} mismatches")
        return wrong

    # -- the loop -----------------------------------------------------------

    def run(self) -> ServeReport:
        cfg = self.cfg
        resumable = (cfg.resume and cfg.ckpt_dir
                     and ckpt.latest_step(cfg.ckpt_dir) is not None)
        snap0 = self._resumed_snapshot() if resumable \
            else self._fresh_snapshot()
        self.store = SnapshotStore(snap0)
        if self.on_start is not None:
            self.on_start(snap0)
        ticks: list[TickStats] = []
        out: list[MicrobatchRecord] = []
        growth: list[GrowthEvent] = []
        history: dict[int, Snapshot] = {}
        if cfg.keep_history:
            history[snap0.version] = snap0
        self._last_aff = None

        for tick in range(snap0.version, cfg.batches):
            snap = self.store.committed
            n_ins, n_del, n_rew = self.scenario.update_counts(
                tick, cfg.batch_size)
            ups = gen.random_batch_updates(
                self.edge_set.edges()[:, :2], cfg.n, n_ins=n_ins,
                n_del=n_del, seed=100 + tick, existing=self.edge_set.pos,
                n_rew=n_rew,
                max_weight=self.scenario.max_weight)
            batch = make_batch(ups, pad_to=cfg.batch_size,
                               device=self.device)
            offsets, qs, qt = self._tick_queries(tick)
            # Insert ops alone move topology slots; deletions flip
            # validity and re-weights touch only w, so a tick without
            # inserts reuses the committed tiling.
            has_ins = any(not int(up[2]) for up in ups)

            # Grow-in-place check before any dispatch: an overflowing
            # batch grows the working snapshot (same version) or raises a
            # typed CapacityError naming this tick. The committed snapshot
            # keeps serving untouched either way.
            work, event = ensure_capacity(snap, batch, self.growth_policy,
                                          grow=cfg.grow, tick=tick)
            if event is not None:
                growth.append(event)
                self._log(f"  grow: capacity {event.old_capacity}->"
                          f"{event.new_capacity}, n {event.old_n}->"
                          f"{event.new_n} (needed {event.required_capacity}"
                          f"/{event.required_n})")

            served_box = [0]
            tick_t0 = time.time()
            # One tiling per tick, prepared from the post-update snapshot;
            # the plan cache keeps the committed snapshot's tiling beside
            # it. Growth changes n or the slot count, which retiles.
            g_next = apply_batch(work.graph, batch)
            plan = self._prepare(g_next,
                                 topology_changed=has_ins or event is not None)
            if cfg.pipeline:
                nxt = self._update_pipelined(work, batch, plan, g_next,
                                             tick, tick_t0, offsets, qs, qt,
                                             served_box, out)
            else:
                nxt = self._update_sync(work, batch, plan, g_next)
            t_upd = time.time() - tick_t0
            self.store.commit(nxt)
            if cfg.keep_history:
                history[nxt.version] = nxt
            served_box[0] = self._drain_rest(
                tick, tick_t0, offsets, qs, qt, served_box[0],
                nxt.version, out)

            self.edge_set.apply(ups)

            tick_mbs = [m for m in out if m.tick == tick]
            lat = (np.concatenate([m.latencies for m in tick_mbs])
                   if tick_mbs else np.zeros((1,)))
            stale = sum(int(m.staleness > 0) * m.qs.shape[0]
                        for m in tick_mbs)
            stats = TickStats(
                tick=tick, version=nxt.version, update_s=t_upd,
                affected=int(self._last_aff.sum()),
                label_size=int(nxt.labelling.label_size()),
                queries=int(served_box[0]),
                grew=event is not None,
                capacity=nxt.graph.capacity, graph_n=nxt.graph.n)
            self._log(
                f"tick {tick}: update {t_upd * 1e3:.1f}ms "
                f"({stats.affected} affected, v{nxt.version}) | "
                f"{stats.queries} queries p50 "
                f"{np.percentile(lat, 50) * 1e3:.1f}ms p99 "
                f"{np.percentile(lat, 99) * 1e3:.1f}ms "
                f"({stale} stale) | label size {stats.label_size}")

            if cfg.verify:
                snapshots = {snap.version: snap, nxt.version: nxt}
                stats.verify_mismatches = self._verify_tick(
                    tick, tick_mbs, snapshots)
            ticks.append(stats)

            if cfg.ckpt_dir:
                t0 = time.time()
                save_snapshot(cfg.ckpt_dir, nxt,
                              extra={"edge_list": self.edge_set.edges(),
                                     "base_n": np.int64(cfg.n)})
                stats.ckpt_s = time.time() - t0
            if self.on_commit is not None:
                self.on_commit(tick, nxt)

        self.report = ServeReport(config=cfg, ticks=ticks, microbatches=out,
                                  final=self.store.committed,
                                  backend=self.backend,
                                  history=history, growth=growth)
        pct = self.report.latency_percentiles()
        mode = "pipeline" if cfg.pipeline else "sync"
        engine = self.engine
        engine_desc = "" if engine is None else (
            f"retiles={engine.retile_count}/{cfg.batches + 1} prepares, "
            f"{engine.plan_cache_hits} plan-cache hits, "
            f"{engine.stale_cache_retiles} stale-cache catches, "
            f"tile-shards={engine.shards}, "
            + (f"tunes={engine.tune_count}, " if engine.autotune else ""))
        self._log(
            f"latency: p50 {pct['p50'] * 1e3:.1f}ms "
            f"p95 {pct['p95'] * 1e3:.1f}ms p99 {pct['p99'] * 1e3:.1f}ms | "
            f"staleness mean {self.report.mean_staleness():.2f} versions "
            f"behind head [{mode}, chunk-sweeps={cfg.chunk_sweeps}, "
            f"scenario={cfg.scenario}]")
        if growth:
            final_g = self.store.committed.graph
            pol = self.growth_policy
            self._log(f"grew {len(growth)}x: capacity "
                      f"{growth[0].old_capacity}->{final_g.capacity}, "
                      f"n {growth[0].old_n}->{final_g.n} "
                      f"[factor={cfg.growth_factor:g}, v-align="
                      f"{pol.block_v * pol.shards}]")
        self._log(f"serve loop done [backend={self.backend}, "
                  f"{engine_desc}{self.device}, {self._mesh_desc()}, "
                  f"mode={mode}]")
        return self.report


def main() -> None:
    # The parser is generated from the spec dataclasses (launch/config.py);
    # `--config <spec.json>` launches from a serialized ServeSpec, and the
    # flat flags override it (warned). `--device` is not part of the spec.
    from repro_torch.launch import config as cfgmod

    ap = cfgmod.build_parser(__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the GPU; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args()
    spec = cfgmod.spec_from_cli(args, ap)
    autotune = spec.engine.autotune or spec.engine.tune_table is not None
    cfg = spec.to_serve_config(autotune=autotune)
    try:
        # Config validation happens at construction; errors inside run()
        # propagate with their tracebacks.
        loop = ServeLoop(cfg, device=args.device)
    except ValueError as e:
        ap.error(str(e))
    report = loop.run()
    if cfg.verify:
        bad = sum(t.verify_mismatches or 0 for t in report.ticks)
        if bad:
            raise SystemExit(f"verify FAILED: {bad} mismatched answers")


if __name__ == "__main__":
    main()
