"""Highway-cover labelling state and landmark-length encodings (PyTorch).

The port of `repro.core.labelling`. The paper's label lists are dense
per-landmark planes:

  dist[R, V]   int32  d_G(r, v)                     (INF_D if unreachable)
  hub[R, V]    bool   some shortest r->v path passes through a landmark
                      other than r (endpoints count)
  highway[R,R] int32  δ_H

Landmark lengths (d, l) and extended landmark lengths (d, l, e) are
encoded as integers so that tuple order is integer order:

  key2(d, l)    = 2*d + (1 - l)
  key4(d, l, e) = 4*d + 2*(1 - l) + (1 - e)

The path-extension operator (d,l) ⊕ w adds the step and clears the l-bit
when the head is a landmark. The add saturates at `inf`: the reference
adds in wrapping int32 and maps a negative sum to `inf`, which for the
non-negative operands it sees is min(a + b, inf). `sat_add` computes that
as min(a, inf - b) + b, which never leaves int32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.graphs.coo import INF_D

INF_KEY2 = 2 * INF_D + 1
INF_KEY4 = 4 * INF_D + 3


def sat_add(a: torch.Tensor, b, inf: int) -> torch.Tensor:
    """min(a + b, inf) for a, b ≥ 0 without int32 overflow."""
    cap = inf - b
    capped = torch.minimum(a, cap) if torch.is_tensor(cap) \
        else a.clamp_max(cap)
    return capped + b


# --- key2: landmark length (d, l) ------------------------------------------

def key2_make(d: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    return 2 * d + (1 - l.to(torch.int32))


def key2_dist(key2: torch.Tensor) -> torch.Tensor:
    return key2 >> 1


def key2_hub(key2: torch.Tensor) -> torch.Tensor:
    return (key2 & 1) == 0


def key2_extend(key2: torch.Tensor, dst_is_hub: torch.Tensor,
                inf: int = INF_KEY2, w=1) -> torch.Tensor:
    """(d,l) ⊕ edge: +w step, saturating at `inf`; force l=True when
    the head is a landmark (≠ r)."""
    out = sat_add(key2, 2 * w, inf)
    return torch.where(dst_is_hub, out & ~1, out)


# --- key4: extended landmark length (d, l, e) -------------------------------

def key4_make(d: torch.Tensor, l: torch.Tensor, e: torch.Tensor
              ) -> torch.Tensor:
    return 4 * d + 2 * (1 - l.to(torch.int32)) + (1 - e.to(torch.int32))


def key4_from_key2(key2: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Lift (d,l) to (d,l,e)."""
    return 2 * key2 + (1 - e.to(torch.int32))


def key4_extend(key4: torch.Tensor, dst_is_hub: torch.Tensor,
                inf: int = INF_KEY4, w=1) -> torch.Tensor:
    """((d,l) ⊕ edge, e): +w step keeps the deletion flag; saturating at
    `inf`."""
    out = sat_add(key4, 4 * w, inf)
    return torch.where(dst_is_hub, out & ~2, out)


def key4_beta(key2_g: torch.Tensor) -> torch.Tensor:
    """β(r, v) = (d^L_G(r,v), True): the improved-search pruning bound."""
    return 2 * key2_g  # e=True encodes as +0


@dataclasses.dataclass(frozen=True)
class HighwayLabelling:
    landmarks: torch.Tensor  # int32[R] vertex ids
    dist: torch.Tensor       # int32[R, V]
    hub: torch.Tensor        # bool[R, V]
    highway: torch.Tensor    # int32[R, R]

    @property
    def num_landmarks(self) -> int:
        return self.landmarks.shape[0]

    def key2(self) -> torch.Tensor:
        """[R, V] encoded landmark distances d^L_G(r, ·)."""
        return key2_make(self.dist, self.hub)

    def label_mask(self) -> torch.Tensor:
        """[R, V] True where the minimal labelling stores an r-label.

        Landmarks store no labels (their distances live in the highway).
        """
        mask = (self.dist < INF_D) & ~self.hub
        return mask & ~landmark_onehot(self.landmarks, self.dist.shape[1])

    def label_size(self) -> torch.Tensor:
        return self.label_mask().sum()

    def label_values(self) -> torch.Tensor:
        """[R, V] label distances, INF_D where no label is stored."""
        return torch.where(self.label_mask(), self.dist, INF_D)


def grow_labelling(lab: HighwayLabelling, new_n: int) -> HighwayLabelling:
    """Widen the labelling planes to `new_n` vertices (grow-in-place).

    New columns hold what a fresh construction at the larger size gives an
    isolated vertex: dist INF_D, hub False. The landmarks and the highway
    are kept; the planes are new tensors, so `lab`'s are never written.
    """
    old_n = lab.dist.shape[1]
    if new_n < old_n:
        raise ValueError(f"grow_labelling cannot shrink: {old_n}->{new_n}")
    if new_n == old_n:
        return lab
    pad = (0, new_n - old_n)
    return HighwayLabelling(
        lab.landmarks,
        torch.nn.functional.pad(lab.dist, pad, value=INF_D),
        torch.nn.functional.pad(lab.hub, pad, value=False),
        lab.highway)


def landmark_onehot(landmarks: torch.Tensor, n: int) -> torch.Tensor:
    """bool[V]: vertex is a landmark.

    `index_fill_` takes the value as a scalar; an indexed assignment of
    one would copy it to the GPU first, a host sync.
    """
    out = torch.zeros(n, dtype=torch.bool, device=landmarks.device)
    return out.index_fill_(0, landmarks.to(torch.int64), True)


def per_plane_hub_mask(landmarks_full: torch.Tensor, own: torch.Tensor,
                       n: int) -> torch.Tensor:
    """[P, V] True where vertex is a landmark *other than* the plane's own.

    The hub-flag rule of the ⊕ operator, shared by construction, search
    and repair. `landmarks_full` is the complete landmark set [R]; `own`
    the owning landmark of each plane [P].
    """
    p = own.shape[0]
    mask = landmark_onehot(landmarks_full, n).expand(p, n).clone()
    return mask.scatter_(1, own.to(torch.int64)[:, None], False)
