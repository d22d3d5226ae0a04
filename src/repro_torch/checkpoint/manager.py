"""The checkpoint stack: atomic fsync'd step trees and the publish protocol.

The port of `repro.checkpoint.manager`, with the same on-disk format, so
each package restores the other's checkpoints:

  * a step is a directory ``step_<n>`` holding one ``.npy`` per leaf and a
    ``manifest.json`` ``{"step": n, "leaves": [names]}``. A tree is nested
    dicts and lists (`repro_torch.tree`) of tensors, numpy arrays or numpy
    scalars; leaves are written in JAX's flatten order (a dict's keys
    sorted, a list's indices in order) and named by their path, dict keys
    and list indices joined by ``__`` — the reference's `_key_str`. A flat
    dict is a tree of depth 1, each leaf named by its key;
  * a bfloat16 leaf is written as the reference writes one: its 16-bit
    patterns under the descr ``<V2`` that `ml_dtypes.bfloat16` gives, so
    the file's bytes equal the reference's (`ml_dtypes` is not needed:
    the header is written by hand). `restore` reads such bits, ``V2`` or
    ``uint16``, back into a bfloat16 template;
  * `save(step)` writes every leaf under ``.tmp_step_<n>``, fsyncs each
    leaf, the manifest and the directory, then renames it to ``step_<n>``
    and fsyncs the parent: a rename that survives a crash implies the
    leaves under it are durable;
  * `publish(step)` flips the ``CURRENT`` pointer file to a saved step by
    write-fsync-rename, after the step's own rename, so a reader that sees
    the new pointer can always load the step it names;
  * `prune(keep=)` never removes a step from the published one forward.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.device import resolve_device

CURRENT = "CURRENT"


def _join(prefix: str, key) -> str:
    return f"{prefix}__{key}" if prefix else str(key)


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(name, leaf) pairs of a tree of dicts and lists in JAX's flatten
    order, named as the reference's `_key_str` names them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k],
                                                        _join(prefix, k))]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in _flatten(t, _join(prefix, i))]
    return [(prefix, tree)]


def _save_leaf(path: str, leaf) -> None:
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        bits = leaf.detach().cpu().contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": bits.shape})
            f.write(bits.tobytes())
        return
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu().numpy()
    np.save(path, np.asarray(leaf))


def _load_leaf(path: str, like, device: torch.device) -> torch.Tensor:
    arr = np.load(path)
    dtype = like.dtype if torch.is_tensor(like) else None
    if dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and (
            arr.dtype.kind == "V" or arr.dtype.name in ("uint16",
                                                        "bfloat16")):
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_json_atomic(path: str, payload: dict) -> None:
    """Write-fsync-rename a small JSON record (pointer files, acks).

    A reader polling `path` sees the old complete record or the new one,
    never a torn write; after the rename returns the record survives a
    crash (file fsync'd before, directory after).
    """
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_path(os.path.dirname(path) or ".")


def read_json(path: str) -> dict | None:
    """Best-effort read of an atomic JSON record (None if absent)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        # A JSONDecodeError can only be a partly visible non-atomic write
        # (e.g. NFS); the poller retries on its next turn.
        return None


def save(ckpt_dir: str, step: int, tree) -> str:
    """Atomically persist `tree` as ``step_<step>``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = []
    for name, leaf in _flatten(tree):
        leaf_path = os.path.join(tmp, name + ".npy")
        _save_leaf(leaf_path, leaf)
        _fsync_path(leaf_path)
        manifest.append(name)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    _fsync_path(tmp)
    os.rename(tmp, final)  # atomic commit
    _fsync_path(ckpt_dir)
    return final


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}")


def step_manifest(ckpt_dir: str, step: int) -> dict | None:
    return read_json(os.path.join(step_dir(ckpt_dir, step), "manifest.json"))


def latest_step(ckpt_dir: str) -> int | None:
    """Newest complete step on disk (scan; `current_step` for published)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def load_leaves(ckpt_dir: str, step: int, names: tuple[str, ...] | None = None,
                mmap: bool = False) -> dict[str, np.ndarray]:
    """Load (a subset of) a step's leaves by name, as numpy arrays.

    `mmap=True` maps each array copy-free (`np.load(mmap_mode="r")`), so
    several readers of one step share one page-cache copy.
    """
    d = step_dir(ckpt_dir, step)
    man = step_manifest(ckpt_dir, step)
    if man is None:
        raise FileNotFoundError(f"no complete checkpoint at {d}")
    want = man["leaves"] if names is None else list(names)
    mode = "r" if mmap else None
    out = {}
    for name in want:
        p = os.path.join(d, name + ".npy")
        if not os.path.exists(p):
            raise FileNotFoundError(f"checkpoint {d} lacks leaf {name!r}")
        out[name] = np.load(p, mmap_mode=mode)
    return out


def restore(ckpt_dir: str, tree_like, shardings=None,
            step: int | None = None, *,
            device: str | torch.device | None = None) -> tuple[object, int]:
    """Restore a tree of `tree_like`'s structure (nested dicts and lists),
    each leaf read from the file its path names and cast to its
    template's dtype; returns (tree, step).

    `shardings`, the reference's elastic re-placement, is a tree of
    `tree_like`'s structure whose leaves are devices: each leaf is
    restored onto the device at its place, or at the nearest node above
    it that is a device. Leaves it leaves out (a missing key, a shorter
    list, a None) land on `device` (None: the GPU, raising without one).
    The port's mesh runs keep their labelling gathered on the mesh's
    first device (`core/shard.py`), so a resume with a mesh restores
    onto that device.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = step_dir(ckpt_dir, step)

    def build(like, where, name: str):
        if isinstance(like, dict):
            return {k: build(v, where.get(k) if isinstance(where, dict)
                             else where, _join(name, k))
                    for k, v in like.items()}
        if isinstance(like, list):
            return [build(v, (where[i] if i < len(where) else None)
                          if isinstance(where, list) else where,
                          _join(name, i)) for i, v in enumerate(like)]
        return _load_leaf(os.path.join(d, name + ".npy"), like,
                          resolve_device(device if where is None else where))
    return build(tree_like, shardings, ""), step


# ---------------------------------------------------------------------------
# Publish protocol (the single-writer / many-reader seam)
# ---------------------------------------------------------------------------

def publish(ckpt_dir: str, step: int, extra: dict | None = None) -> dict:
    """Flip the CURRENT pointer to a saved step, durably.

    The step must already be committed by `save`, so a reader that sees
    the new pointer can always load the step it names. `extra` rides
    along in the pointer record.
    """
    if step_manifest(ckpt_dir, step) is None:
        raise FileNotFoundError(
            f"cannot publish step {step}: no complete checkpoint under "
            f"{step_dir(ckpt_dir, step)}")
    record = {"version": int(step), "path": f"step_{step}"}
    record.update(extra or {})
    write_json_atomic(os.path.join(ckpt_dir, CURRENT), record)
    return record


def read_current(ckpt_dir: str) -> dict | None:
    """The published pointer record, or None before the first publish."""
    return read_json(os.path.join(ckpt_dir, CURRENT))


def current_step(ckpt_dir: str) -> int | None:
    rec = read_current(ckpt_dir)
    return int(rec["version"]) if rec is not None else None


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Remove all but the newest `keep` steps, and never anything from the
    published step forward: a reader starting from CURRENT must find that
    step, and a reader catching up from it must find every step after it.
    """
    if not os.path.isdir(ckpt_dir):
        return
    protected = current_step(ckpt_dir)
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_"))
    for s in steps[:-keep] if keep > 0 else steps:
        if protected is not None and s >= protected:
            continue
        shutil.rmtree(step_dir(ckpt_dir, s), ignore_errors=True)
