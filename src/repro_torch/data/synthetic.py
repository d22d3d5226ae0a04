"""Stateless-seeded synthetic data: batch = f(layout, seed).

The port of `repro.data.synthetic`: `as_specs`, `materialize`, the
LM, GNN and MIND layouts and `coherent_gnn_batch`. A layout is a dict
name -> (shape tuple, torch dtype, kind), kind in {"tokens:<vocab>",
"ids:<max>", "float", "bool", "pos", "angle", "zeros"}. `materialize` and
`coherent_gnn_batch` draw with the reference's
`numpy.random.default_rng(seed)` calls in the reference's order, so
their arrays equal the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def as_specs(layout: dict) -> dict:
    """The layout as meta tensors (shapes and dtypes, no storage): the
    reference's ShapeDtypeStructs, one source of truth with `materialize`.
    """
    return {k: torch.empty(shape, dtype=dtype, device="meta")
            for k, (shape, dtype, _) in layout.items()}


def materialize(layout: dict, seed: int = 0, *,
                device: str | torch.device | None = None) -> dict:
    """Real tensors for `layout`, on the GPU unless `device` says
    otherwise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dtype, kind) in layout.items():
        if kind.startswith("tokens:") or kind.startswith("ids:"):
            hi = int(kind.split(":")[1])
            a = torch.from_numpy(
                rng.integers(0, hi, size=shape).astype(np.int32))
        elif kind == "bool":
            a = torch.ones(shape, dtype=torch.bool)
        elif kind == "pos":
            a = torch.from_numpy(
                rng.normal(size=shape).astype(np.float32) * 2.0)
        elif kind == "angle":
            a = torch.from_numpy(
                rng.uniform(0, np.pi, size=shape).astype(np.float32))
        elif kind == "zeros":
            a = torch.zeros(shape, dtype=dtype)
        else:
            a = torch.from_numpy(
                rng.normal(size=shape).astype(np.float32)).to(dtype)
        out[k] = a.to(dev)
    return out


# ---------------------------------------------------------------------------
# layouts per family
# ---------------------------------------------------------------------------

def lm_train_layout(batch: int, seq: int, vocab: int) -> dict:
    return {
        "tokens": ((batch, seq), torch.int32, f"tokens:{vocab}"),
        "targets": ((batch, seq), torch.int32, f"tokens:{vocab}"),
    }


def lm_decode_layout(batch: int, vocab: int) -> dict:
    return {"tokens": ((batch, 1), torch.int32, f"tokens:{vocab}")}


def lm_prefill_layout(batch: int, seq: int, vocab: int) -> dict:
    return {"tokens": ((batch, seq), torch.int32, f"tokens:{vocab}")}


def gnn_layout(arch: str, n_nodes: int, n_edges_directed: int, d_feat: int,
               d_out: int, n_graphs: int | None = None,
               tri_cap: int | None = None, mesh_ratio: int = 16) -> dict:
    """Shared GNN input layout. n_edges_directed counts each direction."""
    e = n_edges_directed
    lay = {
        "node_feat": ((n_nodes, d_feat), torch.float32, "float"),
        "positions": ((n_nodes, 3), torch.float32, "pos"),
        "src": ((e,), torch.int32, f"ids:{n_nodes}"),
        "dst": ((e,), torch.int32, f"ids:{n_nodes}"),
        "edge_mask": ((e,), torch.bool, "bool"),
        "node_mask": ((n_nodes,), torch.bool, "bool"),
    }
    if n_graphs is not None:
        lay["graph_ids"] = ((n_nodes,), torch.int32, f"ids:{n_graphs}")
        lay["targets"] = ((n_graphs, d_out), torch.float32, "float")
    else:
        lay["targets"] = ((n_nodes, d_out), torch.float32, "float")
    if arch == "dimenet":
        t = tri_cap if tri_cap is not None else 2 * e
        lay.update({
            "tri_kj": ((t,), torch.int32, f"ids:{e}"),
            "tri_ji": ((t,), torch.int32, f"ids:{e}"),
            "tri_mask": ((t,), torch.bool, "bool"),
            "tri_angle": ((t,), torch.float32, "angle"),
        })
    if arch == "graphcast":
        m = max(n_nodes // mesh_ratio, 4)
        me = 4 * m
        lay.update({
            "mesh_pos": ((m, 3), torch.float32, "pos"),
            "g2m_src": ((n_nodes,), torch.int32, f"ids:{n_nodes}"),
            "g2m_dst": ((n_nodes,), torch.int32, f"ids:{m}"),
            "g2m_mask": ((n_nodes,), torch.bool, "bool"),
            "mesh_src": ((me,), torch.int32, f"ids:{m}"),
            "mesh_dst": ((me,), torch.int32, f"ids:{m}"),
            "mesh_mask": ((me,), torch.bool, "bool"),
            "m2g_src": ((n_nodes,), torch.int32, f"ids:{m}"),
            "m2g_dst": ((n_nodes,), torch.int32, f"ids:{n_nodes}"),
            "m2g_mask": ((n_nodes,), torch.bool, "bool"),
        })
    return lay


def mind_train_layout(batch: int, hist_len: int, n_items: int) -> dict:
    return {
        "hist": ((batch, hist_len), torch.int32, f"ids:{n_items}"),
        "hist_mask": ((batch, hist_len), torch.bool, "bool"),
        "target": ((batch,), torch.int32, f"ids:{n_items}"),
    }


def mind_serve_layout(batch: int, hist_len: int, n_items: int,
                      n_cands: int) -> dict:
    return {
        "hist": ((batch, hist_len), torch.int32, f"ids:{n_items}"),
        "hist_mask": ((batch, hist_len), torch.bool, "bool"),
        "cands": ((batch, n_cands), torch.int32, f"ids:{n_items}"),
    }


def mind_retrieval_layout(hist_len: int, n_items: int,
                          n_cands: int) -> dict:
    return {
        "hist": ((1, hist_len), torch.int32, f"ids:{n_items}"),
        "hist_mask": ((1, hist_len), torch.bool, "bool"),
        "cands": ((n_cands,), torch.int32, f"ids:{n_items}"),
    }


# ---------------------------------------------------------------------------
# Coherent small-graph batches (smoke tests need real geometry/topology)
# ---------------------------------------------------------------------------

def coherent_gnn_batch(arch: str, n_nodes: int, avg_deg: int, d_feat: int,
                       d_out: int, seed: int = 0,
                       n_graphs: int | None = None, *,
                       device: str | torch.device | None = None) -> dict:
    """Small but *valid* graph batch: consistent edges, triplets, meshes;
    on the GPU unless `device` says otherwise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n_nodes, 3)).astype(np.float32) * 2.0
    # kNN-ish random graph
    m = n_nodes * avg_deg // 2
    src = rng.integers(0, n_nodes, m)
    dst = rng.integers(0, n_nodes, m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    src2 = np.concatenate([src, dst]).astype(np.int32)
    dst2 = np.concatenate([dst, src]).astype(np.int32)
    e = src2.shape[0]
    batch = {
        "node_feat": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        "positions": pos,
        "src": src2,
        "dst": dst2,
        "edge_mask": np.ones((e,), bool),
        "node_mask": np.ones((n_nodes,), bool),
    }
    if n_graphs is not None:
        gid = (np.arange(n_nodes) * n_graphs // n_nodes).astype(np.int32)
        batch["graph_ids"] = gid
        batch["targets"] = rng.normal(size=(n_graphs, d_out)).astype(
            np.float32)
    else:
        batch["targets"] = rng.normal(size=(n_nodes, d_out)).astype(
            np.float32)
    if arch == "dimenet":
        # Real triplets: (k→j) feeding (j→i), capped.
        by_dst: dict[int, list[int]] = {}
        for eid, dd in enumerate(dst2):
            by_dst.setdefault(int(dd), []).append(eid)
        tk, tj, ang = [], [], []
        cap = 4 * e
        for eid_ji in range(e):
            j = int(src2[eid_ji])
            for eid_kj in by_dst.get(j, [])[:4]:
                if int(src2[eid_kj]) == int(dst2[eid_ji]):
                    continue
                v1 = pos[int(src2[eid_kj])] - pos[j]
                v2 = pos[int(dst2[eid_ji])] - pos[j]
                cos = np.dot(v1, v2) / (np.linalg.norm(v1)
                                        * np.linalg.norm(v2) + 1e-9)
                tk.append(eid_kj)
                tj.append(eid_ji)
                ang.append(np.arccos(np.clip(cos, -1, 1)))
                if len(tk) >= cap:
                    break
            if len(tk) >= cap:
                break
        t = max(len(tk), 1)
        tri_kj = np.zeros(cap, np.int32)
        tri_ji = np.zeros(cap, np.int32)
        tri_angle = np.zeros(cap, np.float32)
        tri_mask = np.zeros(cap, bool)
        # As the reference: with no triplet, slot 0 is written 0 (masked).
        tri_kj[:t] = tk[:t] or [0]
        tri_ji[:t] = tj[:t] or [0]
        tri_angle[:t] = ang[:t] or [0.0]
        tri_mask[:len(tk)] = True
        batch.update({"tri_kj": tri_kj, "tri_ji": tri_ji,
                      "tri_angle": tri_angle, "tri_mask": tri_mask})
    if arch == "graphcast":
        mesh_n = max(n_nodes // 16, 4)
        assign = (np.arange(n_nodes) * mesh_n // n_nodes).astype(np.int32)
        mesh_pos = np.stack([pos[assign == i].mean(0) if (assign == i).any()
                             else np.zeros(3) for i in range(mesh_n)])
        me = 4 * mesh_n
        ms = rng.integers(0, mesh_n, me).astype(np.int32)
        md = rng.integers(0, mesh_n, me).astype(np.int32)
        batch.update({
            "mesh_pos": mesh_pos.astype(np.float32),
            "g2m_src": np.arange(n_nodes, dtype=np.int32),
            "g2m_dst": assign,
            "g2m_mask": np.ones((n_nodes,), bool),
            "mesh_src": ms, "mesh_dst": md,
            "mesh_mask": np.ones((me,), bool),
            "m2g_src": assign,
            "m2g_dst": np.arange(n_nodes, dtype=np.int32),
            "m2g_mask": np.ones((n_nodes,), bool),
        })
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
