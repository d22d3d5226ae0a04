"""Queries of the PyTorch port against `repro`, bit for bit.

`query_upper_bound` through both of its paths — the plain contraction
clamped at INF_D (the reference's default) and the min-plus kernel's
semantics clamped at INF32 (`use_kernel=True`) — `bounded_bibfs` with a
binding `max_steps` (where the batch-wide side choice decides answers),
and `batched_query` on landmark endpoints, s == t and unreachable pairs,
through the COO reference and a tiled plan on the CPU.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import construct as jcon
from repro.core import query as jq
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro_torch import convert as cv
from repro_torch.core import query as tq
from repro_torch.core.engine import RelaxEngine
from repro_torch.graphs.coo import INF_D


def _instance():
    """BA graph plus a detached path 100-101-102: unreachable pairs."""
    edges = np.concatenate([jgen.barabasi_albert(100, 2, seed=1),
                            [[100, 101], [101, 102]]]).astype(np.int32)
    rng = np.random.default_rng(1)
    edges = np.concatenate([edges, rng.integers(1, 4, (len(edges), 1))], 1)
    gj = jcoo.from_edges(103, edges, len(edges) + 4)
    labj = jcon.build_labelling(gj, jcon.select_landmarks_by_degree(gj, 4))
    gt = cv.graph_from_numpy(gj.src, gj.dst, gj.valid, gj.w, gj.n,
                             device="cpu")
    labt = cv.labelling_from_numpy(labj.landmarks, labj.dist, labj.hub,
                                   labj.highway, device="cpu")
    lm = np.asarray(labj.landmarks)
    rng = np.random.default_rng(2)
    s = np.concatenate([lm, [5, 7, 101, 3, lm[0]], rng.integers(0, 103, 20)])
    t = np.concatenate([lm[::-1], [5, 102, 9, 100, 77],
                        rng.integers(0, 103, 20)])
    return gj, labj, gt, labt, s.astype(np.int32), t.astype(np.int32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_upper_bound_matches_reference(use_kernel):
    gj, labj, gt, labt, s, t = _instance()
    got = tq.query_upper_bound(labt, torch.from_numpy(s),
                               torch.from_numpy(t), use_kernel=use_kernel)
    want = jq.query_upper_bound(labj, jnp.asarray(s), jnp.asarray(t),
                                use_kernel=use_kernel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Only the kernel's clamp (INF32) lets an unreachable bound exceed INF_D.
    assert (got.numpy() > INF_D).any() == use_kernel


@pytest.mark.parametrize("max_steps", [1, 2, 3, 64])
def test_bounded_bibfs_matches_reference(max_steps):
    gj, labj, gt, labt, s, t = _instance()
    bound = jq.query_upper_bound(labj, jnp.asarray(s), jnp.asarray(t))
    want = jq.bounded_bibfs(gj, labj.landmarks, jnp.asarray(s),
                            jnp.asarray(t), bound, max_steps)
    got = tq.bounded_bibfs(gt, labt.landmarks, torch.from_numpy(s),
                           torch.from_numpy(t),
                           torch.from_numpy(np.array(bound)), max_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_batched_query_matches_reference(use_kernel, tiled):
    gj, labj, gt, labt, s, t = _instance()
    plan = (RelaxEngine(block_v=16, block_e=8, device="cpu").prepare(gt)
            if tiled else None)
    got = tq.batched_query(gt, labt, torch.from_numpy(s),
                           torch.from_numpy(t), use_kernel=use_kernel,
                           plan=plan).numpy()
    # The answers do not depend on the bound's clamp: the reference's
    # default path is the yardstick for both.
    want = np.asarray(jq.batched_query(gj, labj, jnp.asarray(s),
                                       jnp.asarray(t)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[s == t], 0)
    assert (got == INF_D).any()
