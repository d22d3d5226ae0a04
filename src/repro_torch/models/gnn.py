"""GNN model zoo: SchNet, DimeNet, MACE(-lite), GraphCast.

The port of `repro.models.gnn`, as plain functions over a params tree of
dicts and lists (`repro_torch.tree`). Message passing is gather →
elementwise → segment sum into destination nodes, with validity masks
for padding: every gather is `gather.index_rows` (the rule of JAX's
`x[idx]`) and every aggregation `graphs.segment.masked_segment_sum`
(`jax.ops.segment_sum`'s rule). No hand-written kernel is called: the
reference reaches no Pallas kernel either.

Input convention (a batch dict): node features [N, F], positions
[N, 3], directed edges (src, dst) [E] + edge mask, optional graph ids
[N] for batched small graphs, and (DimeNet only) capped triplet index
lists; GraphCast's batch adds the grid↔mesh topology.

Each contraction takes its inputs in float32 and returns float32 before
the cast to the config's dtype, as the reference's
`preferred_element_type=float32` followed by `.astype(dtype)`; a dense
layer adds its bias in float32 before that cast (one fused product). A
float64 config (the port's own; the reference always accumulates in
float32) computes in float64 throughout, as a float64 recomputation of
the float32 model to hold rounding against. Two
choices keep eager autograd's memory near what XLA needs under `jit`:
DimeNet's `[T, n_bilinear, H]` filter, which depends on no block's
params, is computed once before the block loop (XLA hoists it; the
values are the same, and `bilinear`'s gradient still collects every
block's use), and a masked or out-of-range entry of a segment sum goes
to a scratch segment instead of a masked copy of the messages.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.gather import index_rows
from repro_torch.graphs.segment import masked_segment_sum
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str                  # schnet | dimenet | mace | graphcast
    d_in: int
    d_hidden: int
    d_out: int
    # schnet
    n_interactions: int = 3
    n_rbf: int = 300
    cutoff: float = 10.0
    # dimenet
    n_blocks: int = 6
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    # mace
    n_layers: int = 2
    l_max: int = 2
    correlation: int = 3
    mace_n_rbf: int = 8
    # graphcast
    n_process_layers: int = 16
    mesh_ratio: int = 16       # grid nodes per mesh node (refinement proxy)
    dtype: torch.dtype = torch.float32


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

class _Init:
    """Draws the reference's distributions on one device from one
    generator: normal / √fan_in weights, zero biases."""

    def __init__(self, c: GNNConfig, generator, device):
        self.c, self.gen, self.dev = c, generator, device

    def normal(self, shape, fan_in: int) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.dev)
        return x.div_(math.sqrt(fan_in)).to(self.c.dtype)

    def mlp(self, dims) -> list:
        return [{"w": self.normal((a, b), a),
                 "b": torch.zeros((b,), dtype=self.c.dtype, device=self.dev)}
                for a, b in zip(dims[:-1], dims[1:])]


def _acc(*xs: torch.Tensor) -> torch.dtype:
    """The accumulation dtype: float32, or float64 for float64 inputs."""
    dt = torch.float32
    for x in xs:
        dt = torch.promote_types(dt, x.dtype)
    return dt


def _mlp(layers: list, x: torch.Tensor, act=F.silu,
         final_act: bool = False) -> torch.Tensor:
    for i, l in enumerate(layers):
        acc = _acc(x, l["w"])
        x = F.linear(x.to(acc), l["w"].to(acc).t(),
                     l["b"].to(acc)).to(x.dtype)
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def _rbf_expand(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis with cosine cutoff envelope."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=torch.float32,
                             device=d.device)
    gamma = n_rbf / cutoff
    phi = torch.exp(-gamma * (d[..., None] - centers) ** 2)
    env = 0.5 * (torch.cos(math.pi * torch.clamp(d / cutoff, 0, 1)) + 1.0)
    return phi * env[..., None]


def _edge_vectors(pos: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    vec = index_rows(pos, dst) - index_rows(pos, src)
    d = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-12)
    return vec / d[:, None], d


# ---------------------------------------------------------------------------
# SchNet
# ---------------------------------------------------------------------------

def schnet_init(c: GNNConfig, init: _Init) -> dict:
    h = c.d_hidden
    p = {"embed": init.mlp([c.d_in, h]), "out": init.mlp([h, h, c.d_out])}
    p["blocks"] = [{
        "filter": init.mlp([c.n_rbf, h, h]),
        "in_lin": init.mlp([h, h]),
        "out_mlp": init.mlp([h, h, h]),
    } for _ in range(c.n_interactions)]
    return p


def schnet_forward(p: dict, batch: dict, c: GNNConfig) -> torch.Tensor:
    x = _mlp(p["embed"], batch["node_feat"].to(c.dtype))
    src, dst, emask = batch["src"], batch["dst"], batch["edge_mask"]
    n = x.shape[0]
    _, d = _edge_vectors(batch["positions"], src, dst)
    rbf = _rbf_expand(d, c.n_rbf, c.cutoff).to(c.dtype)
    for blk in p["blocks"]:
        w = _mlp(blk["filter"], rbf)                       # [E, H]
        h = _mlp(blk["in_lin"], x)
        msg = index_rows(h, src) * w
        agg = masked_segment_sum(msg, dst, n, emask)
        x = x + _mlp(blk["out_mlp"], agg)
    return _mlp(p["out"], x)                               # [N, d_out]


# ---------------------------------------------------------------------------
# DimeNet (directional message passing with triplet interactions)
# ---------------------------------------------------------------------------

def dimenet_init(c: GNNConfig, init: _Init) -> dict:
    h = c.d_hidden
    p = {
        "edge_embed": init.mlp([2 * c.d_in + c.n_radial, h]),
        "rbf_lin": init.mlp([c.n_radial, h]),
        "out": init.mlp([h, h, c.d_out]),
        "bilinear": init.normal(
            (c.n_spherical * c.n_radial, c.n_bilinear, h), h),
        "bl_proj": init.mlp([c.n_bilinear * h, h]),
    }
    p["blocks"] = [{
        "msg_mlp": init.mlp([h, h, h]),
        "tri_kj": init.mlp([h, h]),
        "upd": init.mlp([h, h]),
        "out_edge": init.mlp([h, h]),
    } for _ in range(c.n_blocks)]
    return p


def _sbf_expand(d: torch.Tensor, angle: torch.Tensor,
                c: GNNConfig) -> torch.Tensor:
    """Simplified spherical basis: sin-radial × cos(m·angle) outer product
    (the reference's stand-in for spherical Bessel × Legendre)."""
    dn = torch.clamp(d / c.cutoff, 1e-6, 1.0)
    k = torch.arange(1, c.n_radial + 1, dtype=torch.float32, device=d.device)
    radial = torch.sin(math.pi * k * dn[..., None]) / dn[..., None]
    ms = torch.arange(c.n_spherical, dtype=torch.float32, device=d.device)
    angular = torch.cos(ms * angle[..., None])             # [T, n_spherical]
    out = angular[..., :, None] * radial[..., None, :]
    return out.reshape(out.shape[:-2] + (c.n_spherical * c.n_radial,))


def dimenet_forward(p: dict, batch: dict, c: GNNConfig) -> torch.Tensor:
    src, dst, emask = batch["src"], batch["dst"], batch["edge_mask"]
    n = batch["node_feat"].shape[0]
    e = src.shape[0]
    x = batch["node_feat"].to(c.dtype)
    _, d = _edge_vectors(batch["positions"], src, dst)
    rbf = _rbf_expand(d, c.n_radial, c.cutoff).to(c.dtype)

    m = _mlp(p["edge_embed"], torch.cat(
        [index_rows(x, src), index_rows(x, dst), rbf], dim=-1))  # [E, H]

    # Triplets: edge kj feeds edge ji where dst(kj) == src(ji).
    t_kj, t_ji = batch["tri_kj"], batch["tri_ji"]          # [T] edge ids
    t_mask = batch["tri_mask"]
    angle = batch["tri_angle"]                             # [T]
    sbf = _sbf_expand(index_rows(d, t_kj), angle, c).to(c.dtype)  # [T, S*R]
    # The same in every block: computed once (see the module docstring).
    w = _contract("ts,sbh->tbh", sbf, p["bilinear"]).to(c.dtype)

    for blk in p["blocks"]:
        mk = index_rows(_mlp(blk["tri_kj"], m), t_kj)      # [T, H]
        tri_msg = (w * mk[:, None, :]).reshape(sbf.shape[0], -1)
        tri_msg = _mlp(p["bl_proj"], tri_msg)              # [T, H]
        agg = masked_segment_sum(tri_msg, t_ji, e, t_mask)
        m = m + _mlp(blk["upd"], F.silu(_mlp(blk["msg_mlp"], m) + agg))
        m = m + _mlp(blk["out_edge"], _mlp(p["rbf_lin"], rbf) * m)

    node_agg = masked_segment_sum(m, dst, n, emask)
    return _mlp(p["out"], node_agg)


# ---------------------------------------------------------------------------
# MACE-lite (E(3)-equivariant, l ∈ {0,1,2}, product correlation stack)
# ---------------------------------------------------------------------------

def mace_init(c: GNNConfig, init: _Init) -> dict:
    h = c.d_hidden
    p = {"embed": init.mlp([c.d_in, h]), "out": init.mlp([h, h, c.d_out])}
    p["layers"] = [{
        "radial": init.mlp([c.mace_n_rbf, h, 3 * h]),
        "mix0": init.mlp([h, h]),
        "mix1": init.normal((h, h), h),
        "mix2": init.normal((h, h), h),
        "prod": init.mlp([3 * h, h]),
        "upd": init.mlp([2 * h, h]),
    } for _ in range(c.n_layers)]
    return p


def _contract(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """einsum with float32 inputs and a float32 result (float64 for
    float64 inputs)."""
    acc = _acc(*xs)
    return torch.einsum(eq, *(x.to(acc) for x in xs))


def mace_forward(p: dict, batch: dict, c: GNNConfig) -> torch.Tensor:
    """Equivariant message passing. Features: s [N,H] scalars,
    v [N,H,3] vectors (l=1), t [N,H,3,3] traceless-symmetric (l=2)."""
    src, dst, emask = batch["src"], batch["dst"], batch["edge_mask"]
    n = batch["node_feat"].shape[0]
    s = _mlp(p["embed"], batch["node_feat"].to(c.dtype))
    h = s.shape[-1]
    dev = s.device
    v = torch.zeros((n, h, 3), dtype=c.dtype, device=dev)
    t = torch.zeros((n, h, 3, 3), dtype=c.dtype, device=dev)

    u, d = _edge_vectors(batch["positions"], src, dst)     # [E,3], [E]
    rbf = _rbf_expand(d, c.mace_n_rbf, c.cutoff).to(c.dtype)
    # Spherical harmonics of edge direction (unnormalised):
    y1 = u                                                 # l=1: [E, 3]
    eye = torch.eye(3, dtype=c.dtype, device=dev)
    y2 = u[:, :, None] * u[:, None, :] - eye[None] / 3.0   # l=2: [E, 3, 3]

    for lay in p["layers"]:
        w = _mlp(lay["radial"], rbf)                       # [E, 3H]
        w0, w1, w2 = torch.split(w, h, dim=-1)
        s_src = index_rows(s, src)
        # messages (each term is manifestly equivariant)
        m0 = w0 * s_src                                    # scalar msg
        m1 = (w1 * s_src)[..., None] * y1[:, None, :] \
            + w1[..., None] * index_rows(v, src)           # vector msg
        m2 = (w2 * s_src)[..., None, None] * y2[:, None, :, :] \
            + w2[..., None, None] * index_rows(t, src)     # l=2 msg
        a0 = masked_segment_sum(m0, dst, n, emask)
        a1 = masked_segment_sum(m1, dst, n, emask)
        a2 = masked_segment_sum(m2, dst, n, emask)

        # Correlation (order ≤ 3) via invariant contractions:
        inv1 = torch.sum(a1 * a1, dim=-1)                  # |v|² per channel
        inv2 = torch.sum(a2 * a2, dim=(-1, -2))            # |t|²
        inv3 = _contract("nhi,nhij,nhj->nh", a1, a2, a1).to(c.dtype)
        prod = _mlp(lay["prod"], torch.cat([a0, inv1 + inv2, inv3], -1))
        s = s + _mlp(lay["upd"], torch.cat([s, prod], -1))
        v = v + _contract("nhi,hg->ngi", a1, lay["mix1"]).to(c.dtype)
        t = t + _contract("nhij,hg->ngij", a2, lay["mix2"]).to(c.dtype)

    return _mlp(p["out"], s)


# ---------------------------------------------------------------------------
# GraphCast (encoder – processor – decoder over grid↔mesh)
# ---------------------------------------------------------------------------

def _interaction_params(init: _Init, h: int) -> dict:
    return {"edge_mlp": init.mlp([3 * h, h, h]),
            "node_mlp": init.mlp([2 * h, h, h])}


def _interaction(p, x_src, x_dst, e_feat, src, dst, emask, n_dst):
    """GraphNet block: edge update then node update (sum aggregation)."""
    e_in = torch.cat([e_feat, index_rows(x_src, src), index_rows(x_dst, dst)],
                     dim=-1)
    e_new = e_feat + _mlp(p["edge_mlp"], e_in)
    agg = masked_segment_sum(e_new, dst, n_dst, emask)
    x_new = x_dst + _mlp(p["node_mlp"], torch.cat([x_dst, agg], dim=-1))
    return x_new, e_new


def graphcast_init(c: GNNConfig, init: _Init) -> dict:
    h = c.d_hidden
    p = {
        "grid_embed": init.mlp([c.d_in, h]),
        "mesh_embed": init.mlp([4, h]),
        "e_g2m": init.mlp([4, h]),
        "e_mesh": init.mlp([4, h]),
        "e_m2g": init.mlp([4, h]),
        "enc": _interaction_params(init, h),
        "proc": [_interaction_params(init, h)
                 for _ in range(c.n_process_layers)],
        "out": init.mlp([h, h, c.d_out]),
    }
    # The reference draws "dec" from "enc"'s key: it starts equal to it but
    # is its own leaf and trains apart. A copy, never a shared tensor (a
    # shared one would sum both gradients).
    p["dec"] = tree_map(torch.clone, p["enc"])
    return p


def _edge_geo(pos_src, pos_dst, src, dst) -> torch.Tensor:
    rel = index_rows(pos_dst, dst) - index_rows(pos_src, src)
    d = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True) + 1e-12)
    return torch.cat([rel, d], dim=-1)                     # [E, 4]


def graphcast_forward(p: dict, batch: dict, c: GNNConfig) -> torch.Tensor:
    """batch: grid node_feat/positions + mesh topology (precomputed):
    mesh_pos [M,3], g2m (src=grid, dst=mesh), mesh edges, m2g edges."""
    xg = _mlp(p["grid_embed"], batch["node_feat"].to(c.dtype))
    n_grid = xg.shape[0]
    mesh_pos = batch["mesh_pos"]
    n_mesh = mesh_pos.shape[0]
    dev = mesh_pos.device
    xm = _mlp(p["mesh_embed"], _edge_geo(
        mesh_pos, mesh_pos, torch.zeros((n_mesh,), dtype=torch.int32,
                                        device=dev),
        torch.arange(n_mesh, device=dev)))

    # encoder: grid → mesh
    eg = _mlp(p["e_g2m"], _edge_geo(batch["positions"], mesh_pos,
                                    batch["g2m_src"], batch["g2m_dst"])
              .to(c.dtype))
    xm, _ = _interaction(p["enc"], xg, xm, eg, batch["g2m_src"],
                         batch["g2m_dst"], batch["g2m_mask"], n_mesh)

    # processor: message passing on the mesh
    em = _mlp(p["e_mesh"], _edge_geo(mesh_pos, mesh_pos, batch["mesh_src"],
                                     batch["mesh_dst"]).to(c.dtype))
    for blk in p["proc"]:
        xm, em = _interaction(blk, xm, xm, em, batch["mesh_src"],
                              batch["mesh_dst"], batch["mesh_mask"], n_mesh)

    # decoder: mesh → grid
    ed = _mlp(p["e_m2g"], _edge_geo(mesh_pos, batch["positions"],
                                    batch["m2g_src"], batch["m2g_dst"])
              .to(c.dtype))
    xg, _ = _interaction(p["dec"], xm, xg, ed, batch["m2g_src"],
                         batch["m2g_dst"], batch["m2g_mask"], n_grid)
    return _mlp(p["out"], xg)


# ---------------------------------------------------------------------------
# unified entry points
# ---------------------------------------------------------------------------

_INIT = {"schnet": schnet_init, "dimenet": dimenet_init, "mace": mace_init,
         "graphcast": graphcast_init}
_FWD = {"schnet": schnet_forward, "dimenet": dimenet_forward,
        "mace": mace_forward, "graphcast": graphcast_forward}


def init_params(c: GNNConfig, *, generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> dict:
    """Random params of the reference's tree and distributions, on the
    GPU unless `device` says otherwise; `generator` must live on that
    device."""
    return _INIT[c.arch](c, _Init(c, generator, resolve_device(device)))


def forward(params: dict, batch: dict, c: GNNConfig) -> torch.Tensor:
    return _FWD[c.arch](params, batch, c)


def loss_fn(params: dict, batch: dict, c: GNNConfig) -> torch.Tensor:
    """Node-level regression (molecular energies use graph-sum readout)."""
    pred = forward(params, batch, c)
    tgt = batch["targets"]
    if "graph_ids" in batch:
        n_graphs = tgt.shape[0]  # per-graph targets
        pred = masked_segment_sum(pred, batch["graph_ids"], n_graphs,
                                  batch["node_mask"])
        diff = (pred - tgt).to(_acc(pred))
        return torch.mean(diff * diff)
    mask = batch.get("node_mask")
    diff = (pred - tgt).to(_acc(pred))
    sq = torch.sum(diff * diff, dim=-1)
    if mask is not None:
        sq = torch.where(mask, sq, 0.0)
        return torch.sum(sq) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(sq)
