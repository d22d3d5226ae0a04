"""Serving-scenario registry: named workload shapes for the serve loop.

The port's own copy of `repro.data.scenarios`, drawing from the port's
generators (the same rng streams, so a scenario gives both packages the
same batches and queries).

A scenario fixes the two streams the serving pipeline is measured under
(DESIGN.md §5): the *update* stream (how much of each tick's batch is
insertions vs deletions, and whether churn arrives steadily or in
bursts) and the *query* stream (which sources the open-loop query
traffic draws). Everything else — arrival times, batch padding, seeds —
is owned by the serve loop, so scenarios stay pure workload shape and
two loops running the same scenario see bit-identical streams.

Registry (`SCENARIOS` / `get_scenario`):

  mixed         50/50 insert/delete churn, uniform query sources
  insert-heavy  90/10 — the labelling mostly tightens; tilings retile
                every tick (worst case for the plan cache)
  delete-heavy  10/90 — validity-bit churn; tilings are reused across
                ticks (best case for the plan cache)
  bursty        full-size batch every `burst_period`-th tick, a trickle
                otherwise — commit-latency spikes under a steady query
                stream (the staleness stress test)
  skewed        50/50 churn with Zipf(1.2) query sources — traffic
                concentrates on the BA network's hubs
  growth        100/0 — pure insertions, the unbounded-stream shape: the
                edge count climbs every tick (sized so batches ×
                batch_size ≈ the initial edge count doubles the graph
                over a run). Pair with `--capacity`/`--grow` to start
                below the final size and exercise grow-in-place
                (DESIGN.md §6); without --grow it is the scenario that
                deterministically raises CapacityError
  traffic       road-network churn (weighted metric, DESIGN.md §8): most
                of each tick re-weights live edges (congestion spikes and
                decays) around a sparse insert/delete trickle, and every
                `rew_only_period`-th tick is weight-change-only — zero
                slot churn, so served capacity must not shrink. Pair with
                `--graph road` so weights actually vary

`launch/serve.py --scenario <name>` drives these.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.graphs import generators as gen


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One workload shape: update mix per tick + query-source law."""
    name: str
    description: str
    #: fraction of each tick's update batch that is insertions
    ins_frac: float
    #: > 0: only every burst_period-th tick gets the full batch; the
    #: others get `quiet_frac` of it (rounded, min 2 updates)
    burst_period: int = 0
    quiet_frac: float = 0.1
    #: > 0: Zipf exponent for query *sources* (targets stay uniform)
    query_skew: float = 0.0
    #: fraction of each tick's batch that re-weights existing edges
    #: (weighted metric; the remainder splits by ins_frac)
    rew_frac: float = 0.0
    #: > 0: every rew_only_period-th tick (tick > 0) is weight-change
    #: only — no insertions or deletions, so no slot churn
    rew_only_period: int = 0
    #: > 1: inserts/reweights draw uniform weights in [1, max_weight]
    max_weight: int = 1

    def update_counts(self, tick: int,
                      batch_size: int) -> tuple[int, int, int]:
        """(n_ins, n_del, n_rew) for this tick's batch."""
        size = batch_size
        if self.burst_period and tick % self.burst_period:
            size = max(2, int(round(batch_size * self.quiet_frac)))
        if self.rew_only_period and tick > 0 \
                and tick % self.rew_only_period == 0:
            return 0, 0, size
        n_rew = int(round(size * self.rew_frac))
        rest = size - n_rew
        n_ins = int(round(rest * self.ins_frac))
        return n_ins, rest - n_ins, n_rew

    def max_inserts(self, ticks: int, batch_size: int) -> int:
        """Upper bound on total insertions — sizes the graph capacity."""
        return sum(self.update_counts(t, batch_size)[0]
                   for t in range(ticks))

    def sample_queries(self, rng: np.random.Generator, n: int,
                       size: int) -> tuple[np.ndarray, np.ndarray]:
        """One tick's query pairs (sources [size], targets [size])."""
        if self.query_skew > 0:
            src = gen.zipf_vertices(rng, n, size, self.query_skew)
        else:
            src = rng.integers(0, n, size).astype(np.int32)
        dst = rng.integers(0, n, size).astype(np.int32)
        return src, dst


SCENARIOS: dict[str, Scenario] = {s.name: s for s in (
    Scenario("mixed", "50/50 insert/delete churn, uniform queries",
             ins_frac=0.5),
    Scenario("insert-heavy", "90/10 churn: retile-every-tick worst case",
             ins_frac=0.9),
    Scenario("delete-heavy", "10/90 churn: tiling-reuse best case",
             ins_frac=0.1),
    Scenario("bursty", "full batch every 3rd tick, trickle otherwise",
             ins_frac=0.5, burst_period=3),
    Scenario("skewed", "50/50 churn, Zipf(1.2) hub-skewed query sources",
             ins_frac=0.5, query_skew=1.2),
    Scenario("growth", "pure insertions: the edge count climbs every tick "
                       "(grow-in-place stress; pair with --capacity/--grow)",
             ins_frac=1.0),
    Scenario("traffic", "road-network weight churn: spikes/decays on live "
                        "edges + sparse insert/delete trickle; every 4th "
                        "tick is weight-change-only (no slot churn)",
             ins_frac=0.5, rew_frac=0.75, rew_only_period=4, max_weight=8),
)}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; registry: "
            f"{', '.join(sorted(SCENARIOS))}") from None
