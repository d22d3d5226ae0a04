"""Composable serve-tier configuration: typed specs, one CLI, one JSON.

The port of `repro.launch.config`, field for field, so that a `ServeSpec`
JSON written by either package loads in the other. The port's
`ServeLoop` maps `backend` onto its own kernels and `mesh="host"` onto a
mesh of torch devices in one process (`launch/serve.py`,
`launch/mesh.py`).

The serve tier's settings are five composable specs —

  * `GraphSpec`       — the graph under service (family, size, capacity,
                        grow-in-place policy)
  * `EngineSpec`      — the relaxation engine + mesh (backend, tiling,
                        autotune/fusion, shard_map axes)
  * `StreamSpec`      — the workload (update batches, scenario, open-loop
                        query stream, serving mode, verification)
  * `CheckpointSpec`  — durability (checkpoint dir, resume, prune keep)
  * `TopologySpec`    — process topology (reader count, ports, router
                        admission/coalescing, publish-barrier knobs)

— combined in `ServeSpec`, with a **lossless** round-trip through both
representations every role shares:

  * CLI:  `spec.to_args()` emits exactly the non-default flags;
          `from_parsed_args(ns)` inverts it. The parser is *built from
          the specs* (`add_spec_args`), so a flag exists in exactly one
          place.
  * JSON: `spec.to_json()` / `ServeSpec.from_json()` — the updater,
          readers, and router of one deployment are all launched from
          this single serialized document instead of flag duplicates.

The old flat `ServeConfig` (what `ServeLoop` consumes in-process)
remains as the thin legacy adapter: `spec.to_serve_config()` /
`ServeSpec.from_serve_config(cfg)` map between the two by field name.
Mixing flat override flags with `--config` on the CLI still works but
warns — the serialized spec is the source of truth for multi-process
deployments (DESIGN.md §9).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import warnings

from repro_torch.launch.serve import ServeConfig


def _f(default, help_: str, choices: tuple | None = None, arg_type=None):
    """A dataclass field carrying its own CLI metadata."""
    meta = {"help": help_}
    if choices is not None:
        meta["choices"] = choices
    if arg_type is not None:
        meta["type"] = arg_type
    return dataclasses.field(default=default, metadata=meta)


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """The graph under service."""
    n: int = _f(2000, "vertex count (road rounds up to rows*cols)")
    deg: int = _f(4, "Barabási–Albert attachment degree")
    graph: str = _f("ba", "graph family: ba = power-law unit weights, "
                    "road = weighted planar grid", choices=("ba", "road"))
    landmarks: int = _f(16, "highway-cover landmark count R")
    capacity: int | None = _f(None, "initial edge capacity (slot pairs); "
                              "default provisions the scenario's worst case",
                              arg_type=int)
    grow: bool = _f(False, "grow slots + planes geometrically on overflow "
                    "(DESIGN.md §6); without it overflow raises "
                    "CapacityError")
    growth_factor: float = _f(2.0, "geometric growth step (> 1)")

    def realized_n(self) -> int:
        """The vertex count the loop actually serves: `road` rounds n up
        to the grid's rows·cols (the same rule `ServeLoop` applies), so
        out-of-process clients sample queries over the right range."""
        if self.graph != "road":
            return self.n
        import math
        rows = max(2, int(math.isqrt(self.n)))
        cols = max(2, (self.n + rows - 1) // rows)
        return rows * cols


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Relaxation engine + mesh placement."""
    backend: str = _f("auto", "sweep backend: auto/pallas = the relax-sweep "
                      "kernel (its plain version on the CPU), jnp = the "
                      "COO path (CPU only)",
                      choices=("auto", "jnp", "pallas"))
    block_v: int = _f(512, "destination-block size of the kernel tiling")
    tile_shards: int = _f(1, "vertex-shard count of the kernel tiling")
    block_e: int | None = _f(None, "tile-row width cap of the kernel "
                             "tiling (default: widest block)", arg_type=int)
    autotune: bool = _f(False, "measure sweep-impl candidates per snapshot "
                        "shape and adopt the fastest (DESIGN.md §7)")
    tune_table: str | None = _f(None, "on-disk tuning table path (implies "
                                "--autotune)", arg_type=str)
    fused: bool = _f(False, "pipelined chunks as fused megakernel "
                     "dispatches with donated planes (DESIGN.md §7)")
    frontier: bool = _f(False, "frontier-proportional sweeps: relax only "
                        "the tile rows the batch's change frontier touches, "
                        "falling back to full sweeps past the density "
                        "threshold (DESIGN.md §10)")
    frontier_threshold: float = _f(0.25, "masked-sweep density fallback: "
                                   "max fraction of tile rows a frontier "
                                   "wave may gather before the full sweep "
                                   "takes over (autotunable)")
    use_minplus_kernel: bool = _f(False, "kept for spec compatibility: "
                                  "the Eq.-3 bound runs the min-plus "
                                  "kernel on the GPU either way")
    mesh: str = _f("none", "run sharded on a host mesh of the local "
                   "devices (core/shard.py)", choices=("none", "host"))
    shards: int = _f(1, "model-axis size of the host mesh")


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """The workload: update stream + open-loop query stream + mode."""
    batches: int = _f(5, "serving ticks (one update batch + queries each)")
    batch_size: int = _f(100, "edge updates per tick")
    scenario: str = _f("mixed", "workload shape from the registry "
                       "(data/scenarios.py)")
    queries: int = _f(256, "open-loop query arrivals per tick")
    qps: float = _f(2000.0, "Poisson arrival rate of the query stream")
    microbatch: int = _f(32, "max queries per dispatched microbatch (also "
                         "the router's coalescing target)")
    pipeline: bool = _f(False, "serve against the committed snapshot while "
                        "the update runs as bounded chunks (DESIGN.md §5)")
    chunk_sweeps: int = _f(1, "relaxation waves per pipelined dispatch")
    seed: int = _f(7, "seed of the query/arrival streams")
    verify: bool = _f(False, "check sampled answers against the Dijkstra "
                      "oracle at the version each was answered")
    quiet: bool = _f(False, "suppress per-tick logging")


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """Durability of the serve state."""
    ckpt_dir: str | None = _f(None, "checkpoint the full serve state each "
                              "tick (the replica tier's publish dir)",
                              arg_type=str)
    resume: bool = _f(False, "restart from the newest checkpoint in "
                      "--ckpt-dir")
    keep: int | None = _f(None, "prune all but this many steps after each "
                          "commit (the published step is never pruned); "
                          "default keeps everything", arg_type=int)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Process topology of the replica tier (DESIGN.md §9).

    The in-process `ServeLoop` ignores this spec entirely; it configures
    the replica tier (`launch/replica.py`: one updater, `readers` reader
    processes and a router). The device is not part of it: each role
    takes ``--device`` on its own command line, like ``--port``.
    """
    readers: int = _f(2, "reader-replica process count")
    host: str = _f("127.0.0.1", "bind host of the router and readers")
    router_port: int = _f(0, "router client port (0 = pick a free port)")
    reader_port0: int = _f(0, "first reader port; reader k binds "
                           "reader_port0 + k (0 = pick free ports)")
    coalesce_ms: float = _f(2.0, "router coalescing window: wait this long "
                            "to fill a microbatch before dispatching")
    max_queue: int = _f(512, "router admission control: reject new queries "
                        "beyond this many pending")
    slo_ms: float = _f(50.0, "p99 latency SLO (the saturation bench ramps "
                       "qps until this breaks)")
    poll_ms: float = _f(25.0, "reader CURRENT-pointer poll interval")
    barrier_timeout_s: float = _f(30.0, "updater publish barrier: wait at "
                                  "most this long for live readers to ack "
                                  "the previous version")
    restart: bool = _f(False, "orchestrator restarts crashed readers from "
                       "CURRENT")


#: (attribute on ServeSpec, spec class) — parser groups in CLI order.
SPEC_GROUPS: tuple[tuple[str, type], ...] = (
    ("graph", GraphSpec),
    ("engine", EngineSpec),
    ("stream", StreamSpec),
    ("checkpoint", CheckpointSpec),
    ("topology", TopologySpec),
)


def _flag(name: str) -> str:
    return "--" + name.replace("_", "-")


def add_spec_args(parser: argparse.ArgumentParser, cls: type,
                  title: str) -> None:
    """Register one spec's fields as an argument group, defaults from the
    dataclass — the single source of truth for every flag."""
    group = parser.add_argument_group(title)
    for f in dataclasses.fields(cls):
        meta = dict(f.metadata)
        kwargs = {"help": meta.get("help", ""), "default": f.default}
        if f.type == "bool" or isinstance(f.default, bool):
            group.add_argument(_flag(f.name), action="store_true",
                               **kwargs)
            continue
        kwargs["type"] = meta.get("type") or type(f.default)
        if "choices" in meta:
            kwargs["choices"] = meta["choices"]
        group.add_argument(_flag(f.name), **kwargs)


def _spec_from_ns(cls: type, ns: argparse.Namespace):
    return cls(**{f.name: getattr(ns, f.name)
                  for f in dataclasses.fields(cls)})


def _spec_to_args(spec) -> list[str]:
    """The non-default flags of one spec — `add_spec_args`'s inverse."""
    out: list[str] = []
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if v == f.default:
            continue
        if isinstance(v, bool):
            out.append(_flag(f.name))
        else:
            out += [_flag(f.name), str(v)]
    return out


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """The whole serve tier's configuration, composable and serializable.

    One `ServeSpec` describes one deployment — in-process (`ServeLoop`
    via `to_serve_config()`) or multi-process (`launch/replica.py`: the
    updater, every reader, and the router are launched from this one
    document via `to_json()`).
    """
    graph: GraphSpec = dataclasses.field(default_factory=GraphSpec)
    engine: EngineSpec = dataclasses.field(default_factory=EngineSpec)
    stream: StreamSpec = dataclasses.field(default_factory=StreamSpec)
    checkpoint: CheckpointSpec = dataclasses.field(
        default_factory=CheckpointSpec)
    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)

    # -- CLI ----------------------------------------------------------------

    @staticmethod
    def add_args(parser: argparse.ArgumentParser) -> None:
        for attr, cls in SPEC_GROUPS:
            add_spec_args(parser, cls, attr)

    @classmethod
    def from_parsed_args(cls, ns: argparse.Namespace) -> "ServeSpec":
        return cls(**{attr: _spec_from_ns(scls, ns)
                      for attr, scls in SPEC_GROUPS})

    def to_args(self) -> list[str]:
        """Exactly the non-default flags: `parse(to_args())` round-trips
        losslessly (pinned in tests/test_torch_serve.py)."""
        out: list[str] = []
        for attr, _ in SPEC_GROUPS:
            out += _spec_to_args(getattr(self, attr))
        return out

    # -- JSON ---------------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({attr: dataclasses.asdict(getattr(self, attr))
                           for attr, _ in SPEC_GROUPS}, indent=2)

    @classmethod
    def from_json(cls, doc: str) -> "ServeSpec":
        raw = json.loads(doc)
        unknown = set(raw) - {attr for attr, _ in SPEC_GROUPS}
        if unknown:
            raise ValueError(f"unknown config sections {sorted(unknown)}")
        return cls(**{attr: scls(**raw.get(attr, {}))
                      for attr, scls in SPEC_GROUPS})

    def save_json(self, path: str) -> str:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")
        return path

    @classmethod
    def load_json(cls, path: str) -> "ServeSpec":
        with open(path) as fh:
            return cls.from_json(fh.read())

    # -- flat-ServeConfig adapter (legacy surface) --------------------------

    def to_serve_config(self, **overrides) -> ServeConfig:
        """The flat in-process form `ServeLoop` consumes.

        Field names map 1:1; `TopologySpec` and `CheckpointSpec.keep`
        have no flat counterpart (they configure processes around the
        loop, not the loop itself).
        """
        flat_names = {f.name for f in dataclasses.fields(ServeConfig)}
        flat: dict = {}
        for attr, _ in SPEC_GROUPS:
            for f in dataclasses.fields(getattr(self, attr)):
                if f.name in flat_names:
                    flat[f.name] = getattr(getattr(self, attr), f.name)
        flat.update(overrides)
        return ServeConfig(**flat)

    @classmethod
    def from_serve_config(cls, cfg: ServeConfig,
                          topology: TopologySpec | None = None
                          ) -> "ServeSpec":
        """Lift a flat legacy config into specs (by field name)."""
        specs = {}
        for attr, scls in SPEC_GROUPS:
            if scls is TopologySpec:
                continue
            kwargs = {f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(scls)
                      if hasattr(cfg, f.name)}
            specs[attr] = scls(**kwargs)
        specs["topology"] = topology or TopologySpec()
        return cls(**specs)


def build_parser(description: str, config_flag: bool = True
                 ) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    if config_flag:
        parser.add_argument(
            "--config", default=None, metavar="PATH",
            help="serialized ServeSpec JSON — the canonical way to launch "
                 "any serve-tier role; flat flags given alongside it "
                 "override individual fields (deprecated, warns)")
    ServeSpec.add_args(parser)
    return parser


def spec_from_cli(ns: argparse.Namespace,
                  parser: argparse.ArgumentParser) -> ServeSpec:
    """Resolve the CLI into one `ServeSpec`.

    Without ``--config`` the flat flags simply *are* the spec. With it,
    the JSON document is the source of truth and any flat flag that was
    explicitly set to a non-default value overrides its field — the
    deprecated mixed mode, kept so existing wrappers don't break, with a
    warning naming each overridden field.
    """
    flags = ServeSpec.from_parsed_args(ns)
    if getattr(ns, "config", None) is None:
        return flags
    spec = ServeSpec.load_json(ns.config)
    merged = {}
    overridden = []
    for attr, scls in SPEC_GROUPS:
        base, over = getattr(spec, attr), getattr(flags, attr)
        fields = {}
        for f in dataclasses.fields(scls):
            v = getattr(over, f.name)
            if v != f.default and v != getattr(base, f.name):
                fields[f.name] = v
                overridden.append(f.name)
        merged[attr] = dataclasses.replace(base, **fields) if fields \
            else base
    if overridden:
        warnings.warn(
            f"flat flags {overridden} override --config fields; flat "
            f"overrides alongside --config are deprecated — edit the "
            f"serialized spec instead", DeprecationWarning, stacklevel=2)
    return ServeSpec(**merged)
