"""The port's spans and host-read counts (`repro_torch/trace.py`).

Off (the default), a span is one shared null context and
`torch.profiler.record_function` is never entered; a host read returns
what `.tolist()` returns and counts one at its site. A query counts one
read a BiBFS wave and one more that ends the loop (none more where
`max_steps` binds); an update one read a search and repair wave (the
frontier mode one more a fixpoint and one for its boundary rows) and one
a prepare. On, the spans nest under `torch.profiler` as the query and
update paths run them, and every answer and labelling is the same as off.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core.batch import batchhl_update
from repro_torch.core.construct import (build_labelling,
                                        select_landmarks_by_degree)
from repro_torch.core.engine import WAVES, RelaxEngine
from repro_torch.core.query import batched_query
from repro_torch.graphs import coo
from repro_torch.graphs.generators import barabasi_albert

N = 160


@pytest.fixture(autouse=True)
def tracing_off():
    trace.enable(False)
    yield
    trace.enable(False)


def _instance(frontier: bool = False):
    """BA(160, 2) with 8 landmarks, its engine and plan, a deletion and
    insertion batch, and 24 query pairs."""
    edges = barabasi_albert(N, 2, seed=3)
    g = coo.from_edges(N, edges, len(edges) + 16, device="cpu")
    engine = RelaxEngine(block_v=32, frontier=frontier, device="cpu")
    plan = engine.prepare(g)
    lab = build_labelling(g, select_landmarks_by_degree(g, 8), plan=plan)
    rng = np.random.default_rng(4)
    gone = edges[rng.choice(len(edges), 12, replace=False)]
    ups = [(int(u), int(v), coo.OP_DEL) for u, v in gone] + [
        (5, 150, coo.OP_INS), (17, 99, coo.OP_INS)]
    batch = coo.make_batch(ups, pad_to=16, device="cpu")
    s = torch.from_numpy(rng.integers(0, N, 24).astype(np.int32))
    t = torch.from_numpy(rng.integers(0, N, 24).astype(np.int32))
    return g, lab, engine, plan, batch, s, t


def _update(g, lab, engine, batch):
    g2 = coo.apply_batch(g, batch)
    plan = engine.prepare(g2, topology_changed=True)
    return batchhl_update(g, batch, lab, improved=True, plan=plan, g_new=g2)


def test_off_a_span_is_the_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not trace.enabled()
    assert trace.span("query.bound") is trace.span("bhl.commit")
    with trace.span("query.bound") as inside:
        assert inside is None
    assert trace.host_read("fixpoint", torch.tensor(True)) is True
    g, lab, engine, plan, batch, s, t = _instance()
    batched_query(g, lab, s, t, plan=plan)
    _update(g, lab, engine, batch)


@pytest.mark.parametrize("x", [torch.tensor(7), torch.tensor([True, False]),
                               torch.arange(6).reshape(2, 3),
                               torch.tensor([], dtype=torch.int64)])
@pytest.mark.parametrize("on", [False, True])
def test_host_read_returns_tolist_and_counts_its_site(x, on):
    trace.enable(on)
    trace.HOST_READS.clear()
    got = trace.host_read("frontier", x)
    assert got == x.tolist() and type(got) is type(x.tolist())
    assert trace.HOST_READS == {"frontier": 1}
    arr = trace.host_array("prepare.retile", x)
    assert isinstance(arr, np.ndarray)
    np.testing.assert_array_equal(arr, x.numpy())
    assert trace.HOST_READS == {"frontier": 1, "prepare.retile": 1}


@pytest.mark.parametrize("max_steps", [64, 1])
def test_a_query_reads_once_a_wave_and_once_to_stop(max_steps):
    g, lab, engine, plan, batch, s, t = _instance()
    WAVES.clear()
    trace.HOST_READS.clear()
    batched_query(g, lab, s, t, max_steps=max_steps, plan=plan)
    waves = WAVES["bibfs"]
    if max_steps == 1:
        assert waves == 1          # binds: no read after the last wave
        assert trace.HOST_READS == {"query.bibfs": waves}
    else:
        assert 1 < waves < max_steps
        assert trace.HOST_READS == {"query.bibfs": waves + 1}


@pytest.mark.parametrize("frontier", [False, True])
def test_an_update_reads_once_a_wave_and_once_a_prepare(frontier):
    g, lab, engine, plan, batch, s, t = _instance(frontier)
    WAVES.clear()
    trace.HOST_READS.clear()
    _update(g, lab, engine, batch)
    search, repair = WAVES["search_improved"], WAVES["repair"]
    assert search > 0 and repair > 0 and WAVES["repair_base"] == 1
    # The inserting batch retiles: the slot arrays' three pulls.
    want = {"prepare.observe": 1, "prepare.retile": 3}
    if frontier:
        # One read a wave, one that finds the frontier empty, and one for
        # the boundary sweep's rows.
        want["frontier"] = (search + 1) + (repair + 1) + 1
    else:
        want["fixpoint"] = search + repair
    assert trace.HOST_READS == want


def test_batch_requirements_counts_its_read():
    g, lab, engine, plan, batch, s, t = _instance()
    trace.HOST_READS.clear()
    coo.batch_requirements(g, batch)
    assert trace.HOST_READS == {"batch_requirements": 1}


def _spans(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of each user span the profiler kept."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()), key=lambda r: (r[1], -r[2]))


def _parents(spans) -> list[tuple[str, str]]:
    """(span, its innermost enclosing span) for each span, by nesting."""
    out, stack = [], []
    for name, a, b in spans:
        while stack and stack[-1][2] < b:
            stack.pop()
        out.append((name, stack[-1][0] if stack else ""))
        stack.append((name, a, b))
    return out


def _traced(fn):
    trace.enable(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("op"):
            out = fn()
    trace.enable(False)
    return out, _parents(_spans(prof))


def test_query_spans_nest_as_the_query_plane_runs():
    g, lab, engine, plan, batch, s, t = _instance()
    WAVES.clear()
    _, parents = _traced(lambda: batched_query(g, lab, s, t, plan=plan))
    waves = WAVES["bibfs"]
    assert parents.count(("query.bound", "op")) == 1
    assert parents.count(("query.bibfs", "op")) == 1
    assert parents.count(("query.bibfs.wave", "query.bibfs")) == waves
    assert parents.count(("read.query.bibfs", "query.bibfs")) == waves + 1
    assert {p for p, _ in parents} == {
        "op", "query.bound", "query.bibfs", "query.bibfs.wave",
        "read.query.bibfs"}


@pytest.mark.parametrize("frontier", [False, True])
def test_update_spans_nest_as_the_update_runs(frontier):
    g, lab, engine, plan, batch, s, t = _instance(frontier)
    WAVES.clear()
    _, parents = _traced(lambda: _update(g, lab, engine, batch))
    search, repair = WAVES["search_improved"], WAVES["repair"]
    for child, parent, count in [
            ("prepare.observe", "op", 1), ("prepare.retile", "op", 1),
            ("read.prepare.observe", "prepare.observe", 1),
            ("read.prepare.retile", "prepare.retile", 3),
            ("bhl.seed_weights", "op", 1),
            ("bhl.search", "op", 1),
            ("wave.search_improved", "bhl.search", search),
            ("bhl.repair_base", "op", 1),
            ("bhl.edge_masks", "op", 1),
            ("bhl.repair", "op", 1),
            ("wave.repair", "bhl.repair", repair),
            ("bhl.commit", "op", 1)]:
        assert parents.count((child, parent)) == count, child
    if frontier:
        assert parents.count(("read.frontier", "bhl.search")) == search + 1
        assert parents.count(("read.frontier", "bhl.repair")) == repair + 1
        assert parents.count(("read.frontier", "bhl.repair_base")) == 1
    else:
        assert parents.count(("bhl.edge_masks", "bhl.repair_base")) == 1
        assert parents.count(("read.fixpoint", "wave.search_improved")) \
            == search
        assert parents.count(("read.fixpoint", "wave.repair")) == repair


@pytest.mark.parametrize("frontier", [False, True])
def test_answers_and_labellings_are_the_same_on_and_off(frontier):
    g, lab, engine, plan, batch, s, t = _instance(frontier)
    d_off = batched_query(g, lab, s, t, plan=plan)
    g_off, lab_off, aff_off = _update(g, lab, engine, batch)
    (d_on, (g_on, lab_on, aff_on)), _ = _traced(
        lambda: (batched_query(g, lab, s, t, plan=plan),
                 _update(g, lab, engine, batch)))
    assert torch.equal(d_on, d_off) and torch.equal(aff_on, aff_off)
    for a, b in [(g_on.src, g_off.src), (g_on.dst, g_off.dst),
                 (g_on.valid, g_off.valid), (g_on.w, g_off.w),
                 (lab_on.dist, lab_off.dist), (lab_on.hub, lab_off.hub),
                 (lab_on.highway, lab_off.highway),
                 (lab_on.landmarks, lab_off.landmarks)]:
        assert torch.equal(a, b)


@pytest.mark.parametrize("on", [False, True])
def test_a_read_at_an_unknown_site_raises(on):
    trace.enable(on)
    trace.HOST_READS.clear()
    with pytest.raises(KeyError):
        trace.host_read("nowhere", torch.tensor(1))
    assert not trace.HOST_READS
