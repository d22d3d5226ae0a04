"""Uniform fanout neighbour sampler (GraphSAGE-style) for minibatch training.

The port of `repro.graphs.sampler`. It produces fixed-shape padded
subgraphs from a CSR adjacency: for each seed node, sample `fanout[0]`
neighbours, then `fanout[1]` neighbours of those, etc. All shapes are
static (batch_nodes × prod(fanouts)), and nothing is read back to the
host. Optionally it biases sampling toward vertices close to BatchHL
landmarks (distance labels as a sampling prior).

The draws come from a `torch.Generator` on the seeds' device, not from
JAX's key, so they are the reference's rule on other bits. Every gather
follows JAX's indexing rule (`gather.index_rows`): a seed of degree 0 at
the end of the CSR reads one past the last neighbour, which JAX clamps
and masks afterwards, and so does the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.gather import index_rows


@dataclasses.dataclass(frozen=True)
class CSR:
    indptr: torch.Tensor   # int32[V+1]
    indices: torch.Tensor  # int32[E]
    n: int


def build_csr(n: int, edges: np.ndarray, *,
              device: str | torch.device | None = None) -> CSR:
    """CSR from undirected [E,2] numpy edges (both directions), on the
    GPU unless `device` says otherwise."""
    dev = resolve_device(device)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, np.int32)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return CSR(torch.from_numpy(indptr).to(dev),
               torch.from_numpy(dst.astype(np.int32)).to(dev), n)


def _on_device(seeds) -> torch.Tensor:
    """Seeds as a tensor; host arrays go to the GPU, as every entry
    point's default is."""
    if isinstance(seeds, torch.Tensor):
        return seeds
    return torch.as_tensor(np.asarray(seeds), dtype=torch.int32,
                           device=resolve_device(None))


def sample_neighbors(csr: CSR, seeds, fanout: int,
                     generator: torch.Generator | None,
                     bias: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """For each seed, sample `fanout` neighbours with replacement.

    Returns (neighbours [B, fanout] int32, mask [B, fanout] bool).
    Isolated seeds get mask=False. With `bias` (per-vertex scores, e.g.
    closeness to BatchHL landmarks), each sample is drawn twice and the
    higher-bias pick kept; the first draw uses the uniforms an unbiased
    call on an equally seeded generator would.
    """
    seeds = _on_device(seeds)
    dev = seeds.device
    start = index_rows(csr.indptr, seeds)                  # [B]
    deg = index_rows(csr.indptr, seeds + 1) - start
    b = seeds.shape[0]
    span = torch.clamp(deg, min=1)[:, None].to(torch.float32)
    u = torch.rand((b, fanout), generator=generator, device=dev)
    n1 = index_rows(csr.indices, start[:, None] + (u * span).to(torch.int32))
    if bias is not None:
        u2 = torch.rand((b, fanout), generator=generator, device=dev)
        n2 = index_rows(csr.indices,
                        start[:, None] + (u2 * span).to(torch.int32))
        take2 = index_rows(bias, n2) > index_rows(bias, n1)
        nbrs = torch.where(take2, n2, n1)
    else:
        nbrs = n1
    mask = (deg[:, None] > 0).expand(nbrs.shape)
    return torch.where(mask, nbrs, 0), mask


def sample_subgraph(csr: CSR, seeds, fanouts: tuple[int, ...],
                    generator: torch.Generator | None,
                    bias: torch.Tensor | None = None):
    """Multi-hop sampled block: returns per-hop (nodes, mask) lists plus
    flattened (src, dst, edge_mask) COO of the sampled bipartite edges.
    The hops draw one after another from `generator`."""
    seeds = _on_device(seeds)
    ones = torch.ones(seeds.shape, dtype=torch.bool, device=seeds.device)
    layers = [(seeds, ones)]
    srcs, dsts, masks = [], [], []
    cur, cur_mask = seeds, ones
    for f in fanouts:
        flat = cur.reshape(-1)
        nbrs, m = sample_neighbors(csr, flat, f, generator, bias)
        m = m & cur_mask.reshape(-1)[:, None]
        srcs.append(nbrs.reshape(-1))
        dsts.append(flat[:, None].expand(-1, f).reshape(-1))
        masks.append(m.reshape(-1))
        cur, cur_mask = nbrs, m
        layers.append((cur.reshape(-1), cur_mask.reshape(-1)))
    return layers, (torch.cat(srcs), torch.cat(dsts), torch.cat(masks))
