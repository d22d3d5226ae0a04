"""The relaxation engine: one seam for every sweep of the port.

Every wave — construction (`core/construct.py`), batch search Algos 2–3
and batch repair Algo 4 (`core/batch.py`), and the BiBFS expansion
(`core/query.py`) — is one call of

    cand[p, v] = min over masked edges (u, v) of extend(keys[p, u], v)
    extend(k, v) = min(k + step·w(u,v), inf), `clear_bit` cleared when v
                   is a hub landmark of plane p

over an explicit plane axis P (the reference vmaps one plane per call).
`relax_sweep` runs it on the COO arrays in plain PyTorch when `plan` is
None (the reference's "jnp" branch), and through the tiled kernel wrapper
`kernels/edge_relax` when the plan carries a tiling: the CUDA kernel on
the GPU, its plain twin on the CPU.

The reference's `lax.while_loop` fixpoints become host loops with one
host read per wave, the convergence check (`trace.host_read` at site
"fixpoint"). `WAVES` counts the waves of each fixpoint kind and
`trace.HOST_READS` the host reads by site, so a caller can report both:
set them to zero, run, read. With `trace.enable(True)` each fixpoint wave
runs under the span `wave.<kind>` and its read under `read.fixpoint`;
`prepare` runs its fingerprint and cover check under `prepare.observe`, a
retile under `prepare.retile` and the tuner under `prepare.tune`.

A plan may also carry `FrontierTiles` (`RelaxEngine(frontier=True)`): the
batch search and repair of `core/batch.py` then relax, wave by wave, only
the tile rows one block-hop ahead of the blocks that changed, through
`gather_rows` and `relax_rows` below, and fall back to the full sweep
when those rows outgrow the plan's budget.

With `RelaxEngine(autotune=True)` the engine measures, once per snapshot
shape, kernel A under each launch shape of the reference's grid against
the `sorted` impl (`core/autotune.py`) and prepares its plans for the
winner: a kernel tiling of the winner's block_v, block_e and shards, or
a `SortedGraph` that `relax_sweep` runs as PyTorch ops.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch import trace
from repro_torch.core import autotune as tune_mod
from repro_torch.core.labelling import sat_add
from repro_torch.device import resolve_device
from repro_torch.graphs.coo import Graph
from repro_torch.graphs.segment import masked_segment_min
from repro_torch.kernels.edge_relax import ops as er_ops
from repro_torch.kernels.edge_relax.ops import (BlockedGraph, FrontierTiles,
                                                SortedGraph)

#: Waves run per kind ("construct", "search_basic", "search_improved",
#: "repair_base", "repair", "bibfs", and the directed variant's
#: "directed_search" and "directed_bibfs") since the last `WAVES.clear()`. In
#: the frontier mode `kind` still counts every wave, and `kind + ".masked"`
#: counts those that relaxed only the frontier's rows.
WAVES: collections.Counter = collections.Counter()

MAX_WAVES = 1 << 20  # safety valve; loops exit on fixpoint far earlier


@dataclasses.dataclass(frozen=True)
class RelaxPlan:
    """How to run sweeps on one graph snapshot: its prepared tiling, and
    the frontier mode's row tiling when the engine has that mode on.

    `impl` is "kernel" (kernel A on `tiles`) or "sorted" (the PyTorch ops
    of `ops.relax_sweep_sorted` on `sorted_tiles`, `tiles` None), as the
    autotuner picked. Both give the same planes.

    `tiled` (bool [E2]) marks the slots every tiling of the plan holds:
    the live slots of the snapshot it was prepared from. The engine serves
    the plan to a snapshot only while every live slot lies in it.
    """
    tiles: BlockedGraph | None
    frontier: FrontierTiles | None = None
    tiled: torch.Tensor | None = None
    sorted_tiles: SortedGraph | None = None
    impl: str = "kernel"


def relax_sweep(plan: RelaxPlan | None, g: Graph, keys: torch.Tensor,
                step: int, inf: int, *, hub: torch.Tensor | None = None,
                clear_bit: int = 0,
                edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One relaxation wave of all planes `keys` [P, V] over the edges of g.

    plan=None runs the segment-min reference on the COO arrays; a plan
    runs the tiled kernel wrapper, or the `sorted` impl when that is the
    plan's `impl`. `edge_mask` ([E2] or [P, E2]) defaults
    to g.valid and is in original slot order; `hub` [P, V] / `clear_bit`
    realise key2/key4 path extension. The add is step·w(u,v), saturating
    at `inf`.
    """
    mask = g.valid if edge_mask is None else edge_mask
    if plan is None:
        cand = sat_add(keys[:, g.src.to(torch.int64)], step * g.w, inf)
        if hub is not None and clear_bit:
            cand = torch.where(hub[:, g.dst.to(torch.int64)],
                               cand & ~clear_bit, cand)
        return masked_segment_min(cand, g.dst, g.n, mask, inf)
    if plan.impl == "sorted":
        return er_ops.relax_sweep_sorted(keys, plan.sorted_tiles, mask, step,
                                         inf, clear_bit=clear_bit, hub=hub,
                                         w=g.w)
    return er_ops.relax_sweep(keys, plan.tiles, mask, step, inf,
                              clear_bit=clear_bit, hub=hub, w=g.w)


def gather_rows(plan: RelaxPlan, g: Graph, ridx: torch.Tensor):
    """The masked wave's rows `ridx` of `plan.frontier`, shared by every
    plane: (src, global dst, valid, w), each [K, BE]. `valid` is tile
    occupancy and current edge validity, read through the stored slot
    permutation as the kernel tiling does."""
    src_g, dstg, perm_g, slot_g = plan.frontier.gather(ridx)
    perm_g = perm_g.to(torch.int64)
    valid_g = slot_g & g.valid[perm_g]
    w_g = torch.where(slot_g, g.w[perm_g], 0)
    return src_g.to(torch.int64), dstg.to(torch.int64), valid_g, w_g


def relax_rows(keys: torch.Tensor, out: torch.Tensor, src_g: torch.Tensor,
               dstg: torch.Tensor, emask_g: torch.Tensor, w_g: torch.Tensor,
               step: int, inf: int, *, hub: torch.Tensor | None = None,
               clear_bit: int = 0, bound: torch.Tensor | None = None
               ) -> torch.Tensor:
    """One masked wave of all planes: scatter-min the candidates of the
    gathered rows into a copy of `out` [P, V].

    The extend and hub-clear of `relax_sweep`, restricted to the rows.
    keys, hub and bound are [P, V]; the row arrays [K, BE], and emask_g
    [K, BE] or [P, K, BE]. Masked-off slots give `inf`, a no-op in the
    min. `bound` applies the acceptance filter `cand <= bound[dst]` per
    slot: the masked wave never forms the per-destination min first.
    """
    cand = sat_add(keys[:, src_g], step * w_g, inf)           # [P, K, BE]
    if hub is not None and clear_bit:
        cand = torch.where(hub[:, dstg], cand & ~clear_bit, cand)
    if bound is not None:
        cand = torch.where(cand <= bound[:, dstg], cand, inf)
    cand = torch.where(emask_g, cand, inf)
    p = keys.shape[0]
    return out.scatter_reduce(1, dstg.reshape(1, -1).expand(p, -1),
                              cand.reshape(p, -1), "amin")


def fixpoint(kind: str, body_fn, init: torch.Tensor,
             limit: int = MAX_WAVES) -> torch.Tensor:
    """Iterate x <- body_fn(x) (monotone, elementwise) until unchanged, at
    most `limit` waves.

    One host read per wave (site "fixpoint"), the wave under the span
    `wave.<kind>`. Under the reference's vmap each plane's loop ends when
    every plane has converged; extra waves on a converged plane change
    nothing, so one loop over [P, V] gives the same planes.
    """
    x = init
    name = trace.wave_span(kind)
    for _ in range(limit):
        with trace.span(name):
            nx = body_fn(x)
            WAVES[kind] += 1
            changed = bool(trace.host_read("fixpoint", (nx != x).any()))
        x = nx
        if not changed:
            break
    return x


class RelaxEngine:
    """Host-side owner of the tiling cache.

    block_v:  destination-block size of the tiling (the kernel's output
              tile).
    shards:   vertex-shard count of the tiling (the tiles' leading axis;
              the kernel walks (shard, row)). Every value gives
              bit-identical sweeps.
    block_e:  row cap: destination blocks with more slots are chunked
              into several rows. None makes one row per block, padded to
              the largest block — on power-law graphs that is most of the
              tile (see `kernel.block_edges_topology`). Every value gives
              bit-identical sweeps.
    frontier: plans also carry the frontier mode's row tiling (blocks of
              `frontier_block` vertices, masked waves while the active
              rows fit in `frontier_threshold` of them), so batch search
              and repair relax only what the batch's footprint reaches.
              The answers are the same; off by default, as in the
              reference's serving loop.
    autotune: per snapshot shape (n, slot count, shards), measure kernel A
              under each launch shape of the candidate grid against the
              `sorted` impl (`core/autotune.py`) and prepare plans for
              the winner; a kernel winner's block_v and block_e become
              the engine's. `tune_table` (a `TuneTable` or a JSON path)
              keeps the winners, so a restart on the same table measures
              nothing; `tune_count` counts measurement runs.
    cache_plans: plans kept in the fingerprint-keyed LRU (at least 1).
              The default 2 fits a serving pipeline, which keeps two
              snapshots live at once, so re-preparing either must not
              thrash an O(E log E) retile.
    device:   where plans live; None is the GPU (raises without one).
    """

    def __init__(self, block_v: int = 512, block_e: int | None = None, *,
                 shards: int = 1, cache_plans: int = 2,
                 frontier: bool = False,
                 frontier_threshold: float = 0.25, frontier_block: int = 64,
                 autotune: bool = False,
                 tune_table: "tune_mod.TuneTable | str | None" = None,
                 device: str | torch.device | None = None):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if cache_plans < 1:
            raise ValueError(f"cache_plans must be >= 1, got {cache_plans}")
        self.device = resolve_device(device)
        self.block_v = block_v
        self.block_e = block_e
        self.shards = shards
        self.cache_plans = cache_plans
        self.frontier = frontier
        self.frontier_threshold = frontier_threshold
        self.frontier_block = frontier_block
        self.autotune = autotune
        if isinstance(tune_table, str):
            tune_table = tune_mod.TuneTable(tune_table)
        self.tune_table = (tune_table if tune_table is not None
                           else (tune_mod.TuneTable() if autotune else None))
        self._tuned_cfg: tune_mod.TuneConfig | None = None
        self._plan: RelaxPlan | None = None
        self._fingerprint: tuple | None = None
        self._plans: dict[tuple, RelaxPlan] = {}  # fingerprint-keyed LRU
        self.retile_count = 0
        self.stale_cache_retiles = 0  # fingerprint mismatches caught below
        self.plan_cache_hits = 0      # keyed-cache hits (no retile needed)
        self.tune_count = 0           # tuner measurement runs (table misses)
        #: The last measurement run's result (every candidate's times).
        self.last_tune: tune_mod.TuneResult | None = None

    @property
    def plan_alignment(self) -> int:
        """Vertex-count alignment unit for grow-in-place: block_v · shards,
        read from the engine, whose block_v an adopted kernel winner sets,
        so grown snapshots keep the tiles actually served."""
        return self.block_v * self.shards

    @staticmethod
    def _fingerprint_terms(g: Graph) -> torch.Tensor:
        """The fingerprint's two device terms, int64 [2]: the occupied-slot
        count and the unmasked sum of the slot checksum."""
        m32 = 0xFFFFFFFF
        idx = torch.arange(g.src.shape[0], dtype=torch.int64, device=g.device)
        slot_h = (((g.src.to(torch.int64) & m32) * 2654435761
                   + (g.dst.to(torch.int64) & m32) * 40503) & m32) \
            ^ ((idx * 2246822519) & m32)
        return torch.stack([g.valid.sum(dtype=torch.int64), slot_h.sum()])

    @staticmethod
    def snapshot_fingerprint(g: Graph) -> tuple:
        """Cheap identity of a snapshot's topology slots.

        (n, slot count, occupied-slot count, all-slot src/dst checksum),
        the reference's value exactly. The checksum covers every slot,
        free ones included, and mixes each slot's hash with its index: two
        layouts of one edge multiset must not collide, since the tiling
        embeds a slot permutation. The reference hashes in uint32 with
        wraparound; here the same value is taken in int64 and masked to
        32 bits (no product or sum below reaches 2^63).

        It does not tell which slots are live: a deletion and a re-insert
        into the same stale slot pair leave it unchanged. `prepare` checks
        that separately, against the plan's `tiled` slots.
        """
        occupied, chk = trace.host_read(
            "prepare.observe", RelaxEngine._fingerprint_terms(g))
        return (g.n, g.src.shape[0], occupied, chk & 0xFFFFFFFF)

    def _observe(self, g: Graph) -> tuple[tuple, dict]:
        """g's fingerprint, and for each cached plan of g's slot count (by
        key) whether a live slot of g lies outside its tiled slots, in one
        host sync."""
        same = [key for key, plan in self._plans.items()
                if plan.tiled.shape == g.valid.shape]
        terms = torch.cat([self._fingerprint_terms(g)] + [
            (g.valid & ~self._plans[key].tiled).any().reshape(1)
            for key in same])
        occupied, chk, *missed = trace.host_read("prepare.observe", terms)
        fp = (g.n, g.src.shape[0], occupied, chk & 0xFFFFFFFF)
        return fp, dict(zip(same, map(bool, missed)))

    def _cache_is_stale(self, fp: tuple, uncovered: bool) -> bool:
        """True when a snapshot with fingerprint `fp` doesn't match the
        cached tiling; `uncovered`: a live slot lies outside its tiled
        slots.

        Deletion-only churn keeps n, slot count and checksum, can only
        shrink the occupied count and leaves every live slot tiled;
        anything else mismatches.
        """
        n, cap, occupied, chk = self._fingerprint
        n2, cap2, occupied2, chk2 = fp
        return (uncovered or (n2, cap2, chk2) != (n, cap, chk)
                or occupied2 > occupied)

    def prepare(self, g: Graph, topology_changed: bool = True,
                verify_cache: bool = True) -> RelaxPlan:
        """Plan sweeps for snapshot g, reusing the cached tiling when the
        caller vouches that no topology slot changed since the last prepare.

        The vouch is verified against the fingerprint and the tiled slots
        unless `verify_cache=False`; a mismatch retiles
        (`stale_cache_retiles`). Topology changes go through the
        fingerprint-keyed LRU: a snapshot whose slots match a cached tiling,
        and whose live slots it all holds, reuses it (`plan_cache_hits`);
        a key match that misses a live slot retiles and replaces the entry.
        One host read per call (site "prepare.observe"), none for an
        unverified vouch; a retile pulls the slot arrays (site
        "prepare.retile").
        """
        if g.device != self.device:
            raise ValueError(f"graph is on {g.device}, engine on "
                             f"{self.device}")
        cfg = self._ensure_tuned(g)
        if self._plan is not None and not topology_changed \
                and not verify_cache:
            return self._plan
        with trace.span("prepare.observe"):
            fp, uncovered = self._observe(g)
        if self._plan is not None and not topology_changed:
            current = next(k for k, p in self._plans.items()
                           if p is self._plan)
            if not self._cache_is_stale(fp, uncovered.get(current, True)):
                return self._plan
            self.stale_cache_retiles += 1
        # The key carries the tuned config, so that a plan prepared under
        # one winner is never served under another.
        key = fp + ((cfg.impl, cfg.block_v, cfg.block_e, cfg.tile_shards)
                    if cfg else ())
        if self.frontier:
            key += ("frontier", self.frontier_block, self.frontier_threshold)
        plan = self._plans.pop(key, None)
        if plan is None or uncovered.get(key, True):
            with trace.span("prepare.retile"):
                plan = self._retile(g, cfg)
            self.retile_count += 1
        else:
            self.plan_cache_hits += 1
        self._plans[key] = plan  # (re)insert as most-recently used
        while len(self._plans) > self.cache_plans:
            self._plans.pop(next(iter(self._plans)))
        self._plan, self._fingerprint = plan, fp
        return plan

    def _retile(self, g: Graph, cfg: "tune_mod.TuneConfig | None"
                ) -> RelaxPlan:
        """A new plan for g: pull the slot arrays to the host once and
        tile only the occupied slots."""
        src = trace.host_array("prepare.retile", g.src)
        dst = trace.host_array("prepare.retile", g.dst)
        keep = trace.host_array("prepare.retile", g.valid)
        ft = (er_ops.prepare_frontier(
                  src, dst, keep, g.n, self.frontier_block,
                  threshold=self.frontier_threshold, device=self.device)
              if self.frontier else None)
        if cfg is not None and cfg.impl == "sorted":
            return RelaxPlan(None, ft, g.valid.clone(),
                             sorted_tiles=er_ops.prepare_sorted(
                                 src, dst, keep, g.n, device=self.device),
                             impl="sorted")
        shards = cfg.tile_shards if cfg else self.shards
        return RelaxPlan(er_ops.prepare_topology(
            src, dst, keep, g.n, self.block_v, shards, self.block_e,
            device=self.device), ft, g.valid.clone())

    def _ensure_tuned(self, g: Graph) -> "tune_mod.TuneConfig | None":
        """Resolve (and adopt) the tuned config for g's shape.

        The table is keyed (n, slot count, shards): edge churn at a fixed
        shape reuses the winner with no measurement, growth changes the
        key and measures again. Adopting a kernel winner sets block_v and
        block_e, so `plan_alignment` follows the tiles actually served.
        """
        if not self.autotune:
            return None
        key = tune_mod.table_key(g.n, int(g.src.shape[0]), self.shards)
        cfg = self.tune_table.get(key)
        if cfg is None:
            with trace.span("prepare.tune"):
                result = tune_mod.tune(g, shards=self.shards,
                                       block_v=self.block_v)
            self.tune_table.put(key, result)
            self.tune_count += 1
            self.last_tune = result
            cfg = result.config
        if cfg != self._tuned_cfg:
            self._tuned_cfg = cfg
            if cfg.impl == "kernel":
                self.block_v = cfg.block_v
                self.block_e = cfg.block_e
            if cfg.frontier_threshold is not None:
                self.frontier_threshold = cfg.frontier_threshold
        return cfg
