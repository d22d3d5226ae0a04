"""The port's neighbour sampler and segment wrappers against `repro`.

`build_csr` and `molecule_batch` equal the reference's bit for bit. The
sampler draws from a `torch.Generator`, not from JAX's key, so it is held
to the reference's tests by properties: every masked-in sample is an edge
of the CSR, the shapes are static, the masks are right, and a bias is
honoured. Isolated seeds, the last vertex included, give masked rows and
no error. The segment wrappers (min, sum, max, mean) are held to a numpy
loop as `tests/test_graph_substrate.py` holds the reference's: integer
min and max exactly, float sum and mean at rtol = atol = 1e-5; the
hypothesis version skips where hypothesis is absent, and a fixed set of
draws runs everywhere.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import numpy as np
import pytest
import torch

from repro.graphs import generators as jgen
from repro.graphs import sampler as jsampler
from repro_torch.graphs import generators as gen
from repro_torch.graphs import sampler
from repro_torch.graphs.segment import (masked_segment_max,
                                        masked_segment_mean,
                                        masked_segment_min,
                                        masked_segment_sum)


def _adj(edges) -> dict:
    adj: dict = {}
    for u, v in edges:
        adj.setdefault(int(u), set()).add(int(v))
        adj.setdefault(int(v), set()).add(int(u))
    return adj


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# --- bit for bit -------------------------------------------------------------

@pytest.mark.parametrize("n, edges", [
    (200, jgen.barabasi_albert(200, 3, seed=1)),
    # 3, 4 and 6-8 are isolated
    (9, np.array([[1, 2], [2, 5], [5, 1], [0, 5]], np.int32)),
])
def test_build_csr_bit_for_bit(n, edges):
    want = jsampler.build_csr(n, edges)
    got = sampler.build_csr(n, edges, device="cpu")
    assert got.n == want.n == n
    for name in ("indptr", "indices"):
        t, w = getattr(got, name), np.asarray(getattr(want, name))
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


@pytest.mark.parametrize("n_mols, atoms, seed", [(4, 12, 0), (16, 30, 3)])
def test_molecule_batch_bit_for_bit(n_mols, atoms, seed):
    (pw, ew), (pg, eg) = (jgen.molecule_batch(n_mols, atoms, seed),
                          gen.molecule_batch(n_mols, atoms, seed))
    assert pg.dtype == pw.dtype and eg.dtype == ew.dtype
    np.testing.assert_array_equal(pg, pw)
    np.testing.assert_array_equal(eg, ew)


# --- the reference's sampler tests, held by properties -----------------------

def test_sampler_returns_real_neighbors():
    rng = np.random.default_rng(0)
    edges = gen.barabasi_albert(200, 3, seed=1)
    csr = sampler.build_csr(200, edges, device="cpu")
    adj = _adj(edges)
    seeds = torch.from_numpy(rng.integers(0, 200, 64).astype(np.int32))
    nbrs, mask = sampler.sample_neighbors(csr, seeds, 8, _gen(0))
    assert nbrs.shape == mask.shape == (64, 8)
    assert nbrs.dtype == torch.int32 and mask.dtype == torch.bool
    assert bool(mask.all())           # BA: no isolated vertex
    for i, s in enumerate(seeds.tolist()):
        for j in range(8):
            assert int(nbrs[i, j]) in adj[s]


def test_sample_subgraph_shapes_static():
    edges = gen.barabasi_albert(300, 3, seed=2)
    csr = sampler.build_csr(300, edges, device="cpu")
    seeds = torch.arange(16, dtype=torch.int32)
    layers, (src, dst, mask) = sampler.sample_subgraph(csr, seeds, (4, 3),
                                                       _gen(1))
    assert layers[1][0].shape == (16 * 4,)
    assert layers[2][0].shape == (16 * 4 * 3,)
    assert src.shape == dst.shape == mask.shape == (16 * 4 + 16 * 4 * 3,)
    # Each sampled edge joins a node of hop h to one of hop h + 1.
    assert torch.equal(dst[:64], seeds.repeat_interleave(4))
    assert torch.equal(dst[64:], layers[1][0].repeat_interleave(3))
    assert torch.equal(src, torch.cat([layers[1][0], layers[2][0]]))
    adj = _adj(edges)
    assert all(int(s) in adj[int(d)] for s, d, m in zip(src, dst, mask) if m)


def test_sampler_bias_prefers_high_bias_vertices():
    # star graph: vertex 0 connected to all others
    edges = np.array([[0, i] for i in range(1, 51)], np.int32)
    csr = sampler.build_csr(51, edges, device="cpu")
    bias = torch.zeros(51)
    bias[1] = 100.0                   # strongly prefer vertex 1
    seeds = torch.zeros(64, dtype=torch.int32)
    nbrs, _ = sampler.sample_neighbors(csr, seeds, 4, _gen(2), bias=bias)
    nbrs0, _ = sampler.sample_neighbors(csr, seeds, 4, _gen(2))
    frac_v1 = float((nbrs == 1).float().mean())
    frac_v1_unbiased = float((nbrs0 == 1).float().mean())
    assert frac_v1 > frac_v1_unbiased
    # The first draw is the unbiased call's: where it found vertex 1, the
    # biased call kept it.
    assert bool((nbrs[nbrs0 == 1] == 1).all())


def test_biased_pick_is_the_better_of_two_draws():
    edges = gen.barabasi_albert(400, 2, seed=4)
    csr = sampler.build_csr(400, edges, device="cpu")
    bias = torch.from_numpy(np.random.default_rng(5).random(400)
                            .astype(np.float32))
    seeds = torch.arange(400, dtype=torch.int32)
    first, _ = sampler.sample_neighbors(csr, seeds, 6, _gen(7))
    nbrs, mask = sampler.sample_neighbors(csr, seeds, 6, _gen(7), bias=bias)
    assert bool(mask.all())
    assert bool((bias[nbrs.long()] >= bias[first.long()]).all())
    assert float(bias[nbrs.long()].mean()) > float(bias[first.long()].mean())
    adj = _adj(edges)
    assert all(int(v) in adj[int(s)] for s, row in zip(seeds, nbrs)
               for v in row)


def test_isolated_seeds_give_masked_rows():
    """Vertex 8, the last, and 3 have no edge: their rows read one past
    their (empty) neighbour list, which is clamped and masked."""
    edges = np.array([[0, 1], [1, 2], [2, 4], [5, 6], [6, 7]], np.int32)
    csr = sampler.build_csr(9, edges, device="cpu")
    assert int(csr.indptr[8]) == csr.indices.shape[0]
    seeds = torch.tensor([8, 3, 1, 8, 7], dtype=torch.int32)
    for bias in (None, torch.arange(9, dtype=torch.float32)):
        nbrs, mask = sampler.sample_neighbors(csr, seeds, 5, _gen(0), bias)
        assert mask.tolist() == [[False] * 5, [False] * 5, [True] * 5,
                                 [False] * 5, [True] * 5]
        assert not nbrs[~mask].any()
        assert set(nbrs[2].tolist()) <= {0, 2} and set(nbrs[4].tolist()) == {6}
    layers, (src, dst, m) = sampler.sample_subgraph(csr, seeds, (2, 2),
                                                    _gen(1))
    assert not m[:4].any() and not m[6:8].any()   # hop 1 of seeds 8 and 3
    assert not layers[2][1][:8].any()             # and everything below


# --- the segment wrappers against numpy --------------------------------------

def _check_segment_wrappers(seed: int, n: int, e: int) -> None:
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 100, e).astype(np.int32)
    seg = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.6
    fill = 1 << 20
    d, s, m = (torch.from_numpy(x) for x in (data, seg, mask))
    got = masked_segment_min(d, s, n, m, fill)
    want = np.full(n, fill, np.int64)
    for i in range(e):
        if mask[i]:
            want[seg[i]] = min(want[seg[i]], data[i])
    np.testing.assert_array_equal(got.numpy(), want)

    got = masked_segment_max(d, s, n, m, -fill)
    want = np.full(n, -fill, np.int64)
    for i in range(e):
        if mask[i]:
            want[seg[i]] = max(want[seg[i]], data[i])
    np.testing.assert_array_equal(got.numpy(), want)

    fdata = rng.normal(size=(e, 3)).astype(np.float32)
    got_sum = masked_segment_sum(torch.from_numpy(fdata), s, n, m)
    want_sum = np.zeros((n, 3), np.float32)
    for i in range(e):
        if mask[i]:
            want_sum[seg[i]] += fdata[i]
    np.testing.assert_allclose(got_sum.numpy(), want_sum, rtol=1e-5,
                               atol=1e-5)

    got_mean = masked_segment_mean(torch.from_numpy(fdata), s, n, m)
    cnt = np.zeros(n)
    for i in range(e):
        if mask[i]:
            cnt[seg[i]] += 1
    want_mean = want_sum / np.maximum(cnt, 1)[:, None]
    np.testing.assert_allclose(got_mean.numpy(), want_mean, rtol=1e-5,
                               atol=1e-5)


try:
    from hypothesis import HealthCheck, given, settings, strategies as st
except ImportError:
    def test_segment_wrappers_vs_numpy():
        pytest.skip("hypothesis is not installed")
else:
    @settings(deadline=None, max_examples=20,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(0, 10_000), n=st.integers(1, 50),
           e=st.integers(1, 200))
    def test_segment_wrappers_vs_numpy(seed, n, e):
        _check_segment_wrappers(seed, n, e)


@pytest.mark.parametrize("seed, n, e", [(0, 1, 1), (1, 7, 60), (2, 50, 200),
                                        (3, 33, 5)])
def test_segment_wrappers_vs_numpy_fixed_draws(seed, n, e):
    _check_segment_wrappers(seed, n, e)
