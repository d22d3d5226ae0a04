"""Grow-in-place capacity management (DESIGN.md §6).

The port of `repro.core.growth`. A batch that would overflow the edge
slots, or that names a vertex id >= n, grows the slot arrays and the
labelling planes geometrically to the next aligned size; the serve loop
commits the grown arrays with the next version, while queries keep
answering against the committed pre-growth snapshot.

* Detection is on the host and before any dispatch (`ensure_capacity` →
  `coo.batch_requirements`, one host sync): overflow surfaces as a typed
  `CapacityError` naming the tick and the sizes needed.
* Growth is a pure shape change (`coo.grow`, `grow_labelling`,
  `snapshot.grow_snapshot`): new slots are free, new vertices isolated,
  exactly what a fresh construction at the grown size gives them; no
  tensor of the snapshot being grown is written.
* Each step multiplies the overflowing size by at least `factor`, and
  vertex counts round up to block_v · shards
  (`kernel.aligned_vertex_count`), so a grown tiling has a fresh one's
  shape invariants.
* A grown snapshot changes n or the slot count, so the engine retiles for
  it, whatever the caller vouches (`RelaxEngine.prepare`).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.snapshot import Snapshot, grow_snapshot
from repro_torch.graphs import coo
from repro_torch.graphs.coo import BatchUpdate, CapacityError
from repro_torch.kernels.edge_relax.kernel import aligned_vertex_count


@dataclasses.dataclass(frozen=True)
class GrowthPolicy:
    """How far to grow past a requirement, and to what alignment.

    `factor` is the geometric step; `block_v`/`shards` set the vertex-count
    alignment (pass the serving engine's, so grown and fresh tilings share
    shapes); `capacity_align` keeps edge capacities on round slot-pair
    boundaries.
    """
    factor: float = 2.0
    block_v: int = 1
    shards: int = 1
    capacity_align: int = 64

    def __post_init__(self):
        if self.factor <= 1.0:
            raise ValueError(f"growth factor must be > 1, got {self.factor}")

    def next_capacity(self, current: int, required: int) -> int:
        """Smallest aligned capacity >= required that is a geometric step."""
        target = max(required, int(math.ceil(current * self.factor)))
        return -(-target // self.capacity_align) * self.capacity_align

    def next_n(self, current: int, required: int) -> int:
        """Smallest aligned vertex count >= required (geometric step)."""
        target = max(required, int(math.ceil(current * self.factor)))
        return aligned_vertex_count(target, self.block_v, self.shards)


@dataclasses.dataclass(frozen=True)
class GrowthEvent:
    """One growth step, for reports: what grew, when, why."""
    tick: int | None
    old_capacity: int
    new_capacity: int
    old_n: int
    new_n: int
    required_capacity: int
    required_n: int


def ensure_capacity(snap: Snapshot, batch: BatchUpdate,
                    policy: GrowthPolicy = GrowthPolicy(), *,
                    grow: bool = True, tick: int | None = None
                    ) -> tuple[Snapshot, GrowthEvent | None]:
    """Make `snap` big enough to absorb `batch`, growing if allowed.

    Returns (snapshot, event): `snap` itself and None when the batch fits;
    a same-version grown snapshot (plan dropped: prepare it with the
    engine) and the event when it does not and `grow` is set. With
    `grow=False` an overflow raises `CapacityError` carrying the tick and
    the required sizes.
    """
    g = snap.graph
    req_cap, req_n = coo.batch_requirements(g, batch)
    if req_cap <= g.capacity and req_n <= g.n:
        return snap, None
    if not grow:
        raise CapacityError(
            f"batch{f' at tick {tick}' if tick is not None else ''} needs "
            f"edge capacity {req_cap} (have {g.capacity}) and vertex count "
            f"{req_n} (have {g.n}); re-run with growth enabled (--grow) or "
            f"provision a larger --capacity",
            tick=tick, capacity=g.capacity, required_capacity=req_cap,
            n=g.n, required_n=req_n)
    new_cap = (policy.next_capacity(g.capacity, req_cap)
               if req_cap > g.capacity else g.capacity)
    new_n = policy.next_n(g.n, req_n) if req_n > g.n else g.n
    grown = grow_snapshot(snap, capacity=new_cap, n=new_n)
    event = GrowthEvent(tick=tick, old_capacity=g.capacity,
                        new_capacity=new_cap, old_n=g.n, new_n=new_n,
                        required_capacity=req_cap, required_n=req_n)
    return grown, event
