"""The engine's plan cache never serves a tiling that misses a live slot.

Deletions leave a slot's src/dst in place, and an insertion takes the
first free slot pair. So deleting an edge and later re-inserting it can
put it back into its own stale pair: every slot's src/dst is as before,
the snapshot fingerprint (n, slots, occupied count, src/dst checksum) is
as before, and only the set of live slots differs. A plan tiled while the
edge was deleted does not hold it, and must not be served.

The tiled path (`RelaxEngine`, the plain sweep on the CPU) is held to the
port's COO path (`engine=None`) and to `repro.api`, whose default path
takes no plan. The reference's own tiled path has the same fault, so it
is no witness here.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch.core import batch as tbat
from repro_torch.core.engine import RelaxEngine
from repro_torch.core.query import batched_query
from repro_torch.graphs import coo as tcoo

PATH = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5]])
# Tick 1 frees (0, 1)'s slot pair; tick 2 re-inserts (0, 1), which takes
# the first free pair: its own, with src/dst unchanged.
TICKS = [[(0, 1, True)], [(1, 2, True), (0, 1, False)]]


def _engine(frontier=False):
    return RelaxEngine(block_v=4, frontier=frontier, device="cpu")


def _run_path(engine):
    """The 6-vertex case through the port's verbs: (dist, hub, answers of
    every pair) after the two ticks."""
    g, lab = tapi.build(6, PATH, landmarks=[5], capacity=6, device="cpu",
                        engine=engine)
    for ups in TICKS:
        g, lab, _ = tapi.update(g, lab, ups, engine=engine)
    s, t = np.divmod(np.arange(36), 6)
    return lab.dist, lab.hub, tapi.query(g, lab, s, t, engine=engine)


@pytest.mark.parametrize("frontier", [False, True])
def test_reinsert_into_stale_slot_pair(frontier):
    engine = _engine(frontier)
    got = _run_path(engine)
    want = _run_path(None)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2][1].item() == 1   # d(0, 1) once (0, 1) is back

    gj, labj = japi.build(6, PATH, landmarks=[5], capacity=6)
    for ups in TICKS:
        gj, labj, _ = japi.update(gj, labj, ups)
    s, t = np.divmod(np.arange(36), 6)
    np.testing.assert_array_equal(got[2].numpy(), japi.query(gj, labj, s, t))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(labj.dist))
    # Tick 2's snapshot has tick 1's fingerprint, but its key is not a hit:
    # build, tick 1 and tick 2 each tile; the query reuses tick 2's plan.
    assert (engine.retile_count, engine.plan_cache_hits) == (3, 1)


def test_vouched_prepare_catches_reinsert():
    """prepare(g, topology_changed=False) after the re-insert: the cached
    tiling misses a live slot, so `_cache_is_stale` retiles it."""
    engine = _engine()
    g, lab = tapi.build(6, PATH, landmarks=[5], capacity=6, device="cpu",
                        engine=engine)
    g, lab, _ = tapi.update(g, lab, TICKS[0], engine=engine)
    batch = tcoo.make_batch(TICKS[1], device="cpu")
    g2 = tcoo.apply_batch(g, batch)
    assert RelaxEngine.snapshot_fingerprint(g2) == \
        RelaxEngine.snapshot_fingerprint(g)
    plan = engine.prepare(g2, topology_changed=False)
    assert engine.stale_cache_retiles == 1
    assert bool(plan.tiled[g2.valid].all())
    s, t = (torch.from_numpy(x.astype(np.int32))
            for x in np.divmod(np.arange(36), 6))
    out = []
    for p in (plan, None):
        g_new, lab_new, aff = tbat.batchhl_update(g, batch, lab, plan=p,
                                                  g_new=g2)
        out.append((lab_new.dist, lab_new.hub, aff,
                    batched_query(g_new, lab_new, s, t, plan=p)))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert out[0][3][1].item() == 1
    # A vouch for the unchanged snapshot is still served from the cache.
    assert engine.prepare(g2, topology_changed=False) is plan
    assert engine.stale_cache_retiles == 1


def _flapping_ticks(edges, n, ticks, rng):
    """Per tick up to 2 deletions of live edges and 1 re-insertion of an
    edge deleted before (and not back yet)."""
    live = [tuple(map(int, e)) for e in edges]
    gone: list[tuple] = []
    out = []
    for _ in range(ticks):
        ups = []
        for _ in range(int(rng.integers(0, 3))):
            if len(live) > 1:
                u, v = live.pop(int(rng.integers(len(live))))
                ups.append((u, v, True))
                gone.append((u, v))
        back = [e for e in gone if e not in {(u, v) for u, v, _ in ups}]
        if back and rng.random() < 0.8:
            e = back[int(rng.integers(len(back)))]
            gone.remove(e)
            live.append(e)
            ups.append((*e, False))
        out.append(ups)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_flapping_soak_engine_equals_coo(seed):
    n, ticks = 40, 20
    rng = np.random.default_rng(seed)
    edges = jgen.random_connected(n, extra_edges=20, seed=seed)
    s, t = rng.integers(0, n, 48), rng.integers(0, n, 48)
    engine = RelaxEngine(block_v=8, device="cpu")
    state = {}
    for name, eng in (("tiled", engine), ("coo", None)):
        state[name] = tapi.build(n, edges, num_landmarks=4, slack=8,
                                 device="cpu", engine=eng)
    for k, ups in enumerate(_flapping_ticks(edges, n, ticks, rng)):
        got = {}
        for name, eng in (("tiled", engine), ("coo", None)):
            g, lab = state[name]
            if ups:
                g, lab, _ = tapi.update(g, lab, ups, pad_to=4, engine=eng)
            state[name] = (g, lab)
            got[name] = (g.valid, lab.dist, lab.hub,
                          tapi.query(g, lab, s, t, engine=eng))
        for a, b in zip(got["tiled"], got["coo"]):
            assert torch.equal(a, b), f"tick {k}: {ups}"


# --- the same guard for an autotuned engine's sorted plans --------------------

def test_reinsert_into_stale_slot_pair_sorted_plan():
    """The 6-vertex case through an autotuning engine: on the CPU it picks
    the `sorted` impl, whose plan also holds only the slots live at
    prepare time, and the cover check guards it the same way."""
    engine = RelaxEngine(block_v=4, autotune=True, device="cpu")
    got = _run_path(engine)
    want = _run_path(None)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2][1].item() == 1
    assert engine._plan.impl == "sorted" and engine.tune_count == 1
    assert (engine.retile_count, engine.plan_cache_hits) == (3, 1)
    # A vouched prepare after the re-insert retiles the sorted plan too.
    engine = RelaxEngine(block_v=4, autotune=True, device="cpu")
    g, lab = tapi.build(6, PATH, landmarks=[5], capacity=6, device="cpu",
                        engine=engine)
    g, lab, _ = tapi.update(g, lab, TICKS[0], engine=engine)
    g2 = tcoo.apply_batch(g, tcoo.make_batch(TICKS[1], device="cpu"))
    plan = engine.prepare(g2, topology_changed=False)
    assert engine.stale_cache_retiles == 1 and plan.impl == "sorted"
    assert bool(plan.tiled[g2.valid].all())


@pytest.mark.parametrize("seed", range(2))
def test_flapping_soak_sorted_plan_equals_coo(seed):
    """The flapping soak, shortened, through an autotuning engine."""
    n, ticks = 40, 12
    rng = np.random.default_rng(100 + seed)
    edges = jgen.random_connected(n, extra_edges=20, seed=seed)
    s, t = rng.integers(0, n, 48), rng.integers(0, n, 48)
    engine = RelaxEngine(block_v=8, autotune=True, device="cpu")
    state = {name: tapi.build(n, edges, num_landmarks=4, slack=8,
                              device="cpu", engine=eng)
             for name, eng in (("sorted", engine), ("coo", None))}
    for k, ups in enumerate(_flapping_ticks(edges, n, ticks, rng)):
        got = {}
        for name, eng in (("sorted", engine), ("coo", None)):
            g, lab = state[name]
            if ups:
                g, lab, _ = tapi.update(g, lab, ups, pad_to=4, engine=eng)
            state[name] = (g, lab)
            got[name] = (g.valid, lab.dist, lab.hub,
                         tapi.query(g, lab, s, t, engine=eng))
        for a, b in zip(got["sorted"], got["coo"]):
            assert torch.equal(a, b), f"tick {k}: {ups}"
    assert engine._plan.impl == "sorted" and engine.tune_count == 1
