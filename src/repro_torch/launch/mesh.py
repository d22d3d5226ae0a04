"""Host-device mesh: a `(data, model)` grid of torch devices in one process.

The port of `repro.launch.mesh`. The reference's `shard_map` is SPMD under
one controller: one process places the shards and runs the collectives.
Here that controller is this process, holding a grid of `torch.device`s;
`core/shard.py` runs a per-shard body on each grid cell and its
collectives over the per-shard tensors. A device may repeat in the grid,
so a mesh of several shards runs on one card (one after another, on its
one stream) or, for the tests, on the CPU.

Axis roles as in the reference: `data` takes query-batch shards (and
landmark planes during maintenance), `model` landmark planes.

The production geometry (`make_production_mesh`) and the placement spec
`P` describe the reference's TPU pods for the dry run
(`launch/dryrun.py`): axis names and sizes, no device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device

AXES = ("data", "model")


class Mesh:
    """A `(data, model)` grid of devices; `grid[d][m]` is the device of
    shard (d, m). `shape["data"]` and `shape["model"]` read as the
    reference's `mesh.shape` does.

    Each entry is settled as `resolve_device` settles it, so `"cuda"`
    names the current card with its index and compares equal to the
    devices of the tensors placed there. An entry of None is refused: a
    grid names its devices."""

    def __init__(self, grid):
        rows = [tuple(_grid_device(x) for x in row) for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh grid needs equal, non-empty rows")
        self.grid = tuple(rows)
        self.shape = {"data": len(rows), "model": len(rows[0])}

    @property
    def devices(self) -> list[torch.device]:
        """Every shard's device, row-major (data-major)."""
        return [x for row in self.grid for x in row]

    @property
    def first(self) -> torch.device:
        """The device that gathered outputs land on."""
        return self.grid[0][0]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, "
                f"model={self.shape['model']}, devices={self.devices})")


def _grid_device(x) -> torch.device:
    if x is None:
        raise ValueError("a mesh grid entry must name a device, not None")
    return resolve_device(x)


def make_host_mesh(model: int = 1, *, device=None, devices=None) -> Mesh:
    """Host mesh over the local devices: (data = n // model, model).

    By default the devices are every local device of `device`'s type, as
    `resolve_device` settles it (None: the GPU, raising without one):
    `torch.cuda.device_count()` cards, or one CPU. `devices=` lists them
    instead, repeats allowed (the tests pass 8 × cpu). Device i of the
    list is shard (i // model, i % model), the order of `jax.make_mesh`.
    """
    if devices is None:
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    n = len(devices)
    if model < 1 or n % model:
        raise ValueError(
            f"model-axis size {model} must divide the {n} local devices")
    return Mesh([devices[d * model:(d + 1) * model]
                 for d in range(n // model)])


class P(tuple):
    """A placement spec, the reference's `PartitionSpec`: one entry per
    leading dim of a tensor, each None (replicated), an axis name, or a
    tuple of axis names (the dim split over the product of their sizes);
    dims past the entries are replicated. A one-name tuple reads as the
    name, as JAX's spec does, so `P(("data",), None) == P("data", None)`.
    """
    __slots__ = ()

    def __new__(cls, *parts):
        return super().__new__(cls, (_spec_entry(x) for x in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"

    def axes(self, dim: int) -> tuple[str, ...]:
        """The axis names that split `dim` (none past the entries)."""
        if dim >= len(self) or self[dim] is None:
            return ()
        return (self[dim],) if isinstance(self[dim], str) else self[dim]


def _spec_entry(x):
    if x is None or isinstance(x, str):
        return x
    x = tuple(x)
    if not x or not all(isinstance(a, str) for a in x):
        raise ValueError(f"a spec entry is None, an axis name or a tuple "
                         f"of axis names, not {x!r}")
    return x[0] if len(x) == 1 else x


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh that names no device."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size}, as the reference's `mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production geometry (TPU v5e pods): one pod of 256
    chips as (data=16, model=16), or two pods as (pod=2, data=16,
    model=16). Axis roles: `data` batch/FSDP/vertex shards, `model`
    tensor/expert/landmark parallel, `pod` more data parallelism."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))
