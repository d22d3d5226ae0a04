"""The port's checkpoint stack against `repro`'s: one on-disk format.

A snapshot saved by `repro` restores in the port and the port's save of
the same state restores in `repro`, with equal leaves both ways; the two
`step_<v>` trees are byte-identical file by file (`.npy` and
`manifest.json`). Also the full-state contract (graph slots, the weight
column, named errors for older formats), the publish/prune protocol,
nested trees of dicts and lists under the reference's key-path names
(restored in either package), and bfloat16 leaves: through `convert` by
their bits, and in checkpoints byte for byte as the reference writes
them.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro.checkpoint import manager as jckpt
from repro.core import batch as jbat
from repro.core import construct as jcon
from repro.core import snapshot as jsnap
from repro.graphs import coo as jcoo
from repro.graphs import generators as jgen
from repro_torch import convert as cv
from repro_torch.checkpoint import manager as tckpt
from repro_torch.core import snapshot as tsnap


@pytest.fixture(scope="module")
def state():
    """A weighted snapshot after one mixed batch (re-weights included),
    in both packages."""
    n = 30
    edges = jgen.random_connected(n, extra_edges=15, seed=2)
    w = np.random.default_rng(3).integers(1, 8, (len(edges), 1))
    ew = np.concatenate([edges, w], 1).astype(np.int32)
    gj = jcoo.from_edges(n, ew, len(ew) + 8)
    labj = jcon.build_labelling(gj, jcon.select_landmarks_by_degree(gj, 4))
    bj = jcoo.make_batch(jgen.random_batch_updates(
        ew, n, n_ins=2, n_del=1, seed=3, n_rew=2, max_weight=6), pad_to=8)
    g2, lab2, _ = jbat.batchhl_update(gj, bj, labj)
    snapj = jsnap.Snapshot(5, g2, lab2, None)
    snapt = tsnap.Snapshot(
        5, cv.graph_from_numpy(g2.src, g2.dst, g2.valid, g2.w, g2.n,
                               device="cpu"),
        cv.labelling_from_numpy(lab2.landmarks, lab2.dist, lab2.hub,
                                lab2.highway, device="cpu"))
    return snapj, snapt


def _assert_same_snapshot(got, want):
    assert got.version == want.version and got.graph.n == want.graph.n
    for f in ("src", "dst", "valid", "w"):
        np.testing.assert_array_equal(np.asarray(getattr(got.graph, f)),
                                      np.asarray(getattr(want.graph, f)))
    for f in ("landmarks", "dist", "hub", "highway"):
        np.testing.assert_array_equal(np.asarray(getattr(got.labelling, f)),
                                      np.asarray(getattr(want.labelling, f)))


def test_cross_package_trees_are_byte_identical(state, tmp_path):
    snapj, snapt = state
    extra = {"edge_list": np.arange(12, dtype=np.int32).reshape(4, 3),
             "base_n": np.int64(30)}
    pj = jsnap.save_snapshot(str(tmp_path / "j"), snapj, extra=extra)
    pt = tsnap.save_snapshot(str(tmp_path / "t"), snapt, extra=extra)
    assert os.path.basename(pj) == os.path.basename(pt) == "step_5"
    names = sorted(os.listdir(pj))
    assert names == sorted(os.listdir(pt))
    assert "manifest.json" in names and len(names) == 13
    match, mismatch, errors = filecmp.cmpfiles(pj, pt, names, shallow=False)
    assert mismatch == [] and errors == [] and sorted(match) == names
    with open(os.path.join(pt, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 5 and man["leaves"] == sorted(man["leaves"])


def test_reference_checkpoint_restores_in_the_port(state, tmp_path):
    snapj, _ = state
    jsnap.save_snapshot(str(tmp_path), snapj)
    back = tsnap.restore_snapshot(str(tmp_path), device="cpu")
    assert back.plan is None and back.graph.device.type == "cpu"
    _assert_same_snapshot(back, snapj)
    mapped = tsnap.restore_snapshot(str(tmp_path), mmap=True, device="cpu")
    _assert_same_snapshot(mapped, snapj)


def test_port_checkpoint_restores_in_the_reference(state, tmp_path):
    snapj, snapt = state
    tsnap.publish_snapshot(str(tmp_path), snapt,
                           extra={"base_n": np.int64(30)})
    _assert_same_snapshot(jsnap.restore_snapshot(str(tmp_path)), snapj)
    assert jckpt.current_step(str(tmp_path)) == 5
    assert int(jsnap.restore_extra(str(tmp_path), ("base_n",))["base_n"]) \
        == 30


def test_checkpoint_roundtrips_weight_column(state, tmp_path):
    _, snapt = state
    tsnap.save_snapshot(str(tmp_path / "ck"), snapt)
    back = tsnap.restore_snapshot(str(tmp_path / "ck"), device="cpu")
    assert back.version == 5
    assert back.graph.w.equal(snapt.graph.w)
    assert back.graph.valid.equal(snapt.graph.valid)
    assert back.graph.w.max() > 1   # the column really is weighted


def test_checkpoint_carries_graph_state(state, tmp_path):
    """The full-state checkpoint restores the graph's slots, not just the
    labelling; a labelling-only or an unweighted checkpoint errors by
    name."""
    _, snapt = state
    tsnap.save_snapshot(str(tmp_path / "full"), snapt)
    _assert_same_snapshot(
        tsnap.restore_snapshot(str(tmp_path / "full"), device="cpu"), snapt)
    lab = snapt.labelling
    tckpt.save(str(tmp_path / "old"), 1,
               {"dist": lab.dist, "hub": lab.hub, "highway": lab.highway,
                "landmarks": lab.landmarks})
    with pytest.raises(FileNotFoundError, match="graph state"):
        tsnap.restore_snapshot(str(tmp_path / "old"), device="cpu")
    tsnap.save_snapshot(str(tmp_path / "unw"), snapt)
    os.remove(tmp_path / "unw" / "step_5" / "graph_w.npy")
    with pytest.raises(tsnap.UnweightedCheckpointError,
                       match="weighted-metric format"):
        tsnap.restore_snapshot(str(tmp_path / "unw"), device="cpu")
    assert issubclass(tsnap.UnweightedCheckpointError, FileNotFoundError)
    with pytest.raises(ValueError, match="collides"):
        tsnap.save_snapshot(str(tmp_path / "x"), snapt,
                            extra={"dist": np.zeros(1)})


def test_manager_save_restore_and_nested_names(tmp_path):
    """Leaves are named and ordered as JAX flattens a dict; `restore`
    casts to the template's dtypes on the given device; a nested tree's
    names join keys with '__', as the reference's do."""
    tree = {"b": torch.arange(3, dtype=torch.int32), "a": np.float32(2.5),
            "c": {"y": torch.ones(2, dtype=torch.bool),
                  "x": np.int64(7)}}
    tckpt.save(str(tmp_path / "t"), 3, tree)
    jckpt.save(str(tmp_path / "j"), 3,
               {"b": np.arange(3, dtype=np.int32), "a": np.float32(2.5),
                "c": {"y": np.ones(2, bool), "x": np.int64(7)}})
    names = ["a", "b", "c__x", "c__y"]
    assert tckpt.step_manifest(str(tmp_path / "t"), 3)["leaves"] == names
    for name in names + ["manifest"]:
        ext = ".json" if name == "manifest" else ".npy"
        assert filecmp.cmp(tmp_path / "t" / "step_3" / (name + ext),
                           tmp_path / "j" / "step_3" / (name + ext),
                           shallow=False), name
    like = {"b": torch.zeros(3, dtype=torch.int64),
            "c__y": torch.zeros(2, dtype=torch.bool)}
    back, step = tckpt.restore(str(tmp_path / "t"), like, device="cpu")
    assert step == 3 and back["b"].dtype == torch.int64
    assert back["b"].tolist() == [0, 1, 2] and back["c__y"].all()
    leaves = tckpt.load_leaves(str(tmp_path / "t"), 3, ("a", "c__x"),
                               mmap=True)
    assert float(leaves["a"]) == 2.5 and int(leaves["c__x"]) == 7
    with pytest.raises(FileNotFoundError, match="lacks leaf"):
        tckpt.load_leaves(str(tmp_path / "t"), 3, ("nope",))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tckpt.restore(str(tmp_path / "empty"), like, device="cpu")


def test_elastic_restore_with_sharding(tmp_path):
    """Restore places each leaf on the device `shardings` names at its
    place or above it (the mirror of `tests/test_train_infra.py`'s test
    of that name); leaves it does not name land on `device=`. The
    reference restores the port's step with its own shardings to the
    same values."""
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
            "opt": {"m": torch.ones(3), "step": torch.tensor(5)}}
    d = str(tmp_path / "ck")
    tckpt.save(d, 2, tree)
    back, step = tckpt.restore(d, {"w": tree["w"]},
                               shardings={"w": torch.device("cpu")})
    assert step == 2 and back["w"].device == torch.device("cpu")
    assert torch.equal(back["w"], tree["w"])
    sub, _ = tckpt.restore(d, {"opt": tree["opt"]}, {"opt": "cpu"})
    assert torch.equal(sub["opt"]["m"], tree["opt"]["m"])  # a subtree's device
    back, _ = tckpt.restore(d, tree, {"opt": {"m": "cpu"}}, device="cpu")
    assert all(torch.equal(a, b) for a, b in ((back["w"], tree["w"]), (
        back["opt"]["m"], tree["opt"]["m"]), (back["opt"]["step"],
                                              tree["opt"]["step"])))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    sh = {"w": NamedSharding(mesh, PartitionSpec("data", None))}
    jback, _ = jckpt.restore(d, {"w": np.zeros((4, 4), np.float32)},
                             shardings=sh)
    assert jback["w"].sharding == sh["w"]
    np.testing.assert_array_equal(np.asarray(jback["w"]), tree["w"].numpy())


def test_publish_and_prune_protect_the_published_range(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None and tckpt.read_current(d) is None
    for s in range(6):
        tckpt.save(d, s, {"x": np.int64(s)})
    with pytest.raises(FileNotFoundError, match="cannot publish"):
        tckpt.publish(d, 9)
    rec = tckpt.publish(d, 2, extra={"base": "cfg"})
    assert rec == {"version": 2, "path": "step_2", "base": "cfg"}
    assert jckpt.read_current(d) == rec and tckpt.current_step(d) == 2
    tckpt.prune(d, keep=1)
    left = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                  if x.startswith("step_"))
    assert left == [2, 3, 4, 5] and tckpt.latest_step(d) == 5
    tckpt.write_json_atomic(os.path.join(d, "ack.json"), {"v": 1})
    assert tckpt.read_json(os.path.join(d, "ack.json")) == {"v": 1}
    assert not os.path.exists(os.path.join(d, "ack.json.tmp"))


# --- nested trees and bfloat16 leaves ---------------------------------------

def _nested_np() -> dict:
    rng = np.random.default_rng(5)
    return {"p": {"embed": rng.normal(size=(4, 3)).astype(np.float32),
                  "layers": [rng.normal(size=(2,)).astype(np.float32),
                             {"w": np.arange(6, dtype=np.int32).reshape(2,
                                                                        3)}]},
            "opt": {"step": np.int32(2),
                    "m": [np.zeros(3, np.float32), np.ones(1, np.float32)]}}


def test_nested_tree_names_and_restore_match_reference(tmp_path):
    """Nested dicts and lists are saved under the reference's key-path
    names, byte for byte, and restore into a tree of the template's
    structure in either package."""
    import jax
    import jax.numpy as jnp
    tree = _nested_np()
    tckpt.save(str(tmp_path / "t"), 2, cv.params_from_numpy(tree,
                                                            device="cpu"))
    jckpt.save(str(tmp_path / "j"), 2, jax.tree.map(jnp.asarray, tree))
    names = ["opt__m__0", "opt__m__1", "opt__step", "p__embed",
             "p__layers__0", "p__layers__1__w"]
    assert tckpt.step_manifest(str(tmp_path / "t"), 2)["leaves"] == names
    assert jckpt.step_manifest(str(tmp_path / "j"), 2)["leaves"] == names
    for name in names + ["manifest"]:
        ext = ".json" if name == "manifest" else ".npy"
        assert filecmp.cmp(tmp_path / "t" / "step_2" / (name + ext),
                           tmp_path / "j" / "step_2" / (name + ext),
                           shallow=False), name
    like = cv.params_from_numpy(jax.tree.map(np.zeros_like, tree),
                                device="cpu")
    back, step = tckpt.restore(str(tmp_path / "j"), like, device="cpu")
    assert step == 2 and isinstance(back["p"]["layers"], list)
    assert back["p"]["layers"][1]["w"].dtype == torch.int32
    assert back["opt"]["step"].shape == () and int(back["opt"]["step"]) == 2
    for got, want in zip(jax.tree_util.tree_leaves(cv.params_to_numpy(back)),
                         jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got, want)
    jback, _ = jckpt.restore(str(tmp_path / "t"),
                             jax.tree.map(jnp.zeros_like, tree))
    for got, want in zip(jax.tree_util.tree_leaves(jback),
                         jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_bfloat16_through_convert():
    """A JAX bfloat16 array (numpy dtype `ml_dtypes.bfloat16`) becomes a
    torch bfloat16 tensor with the same bits, and comes back as uint16
    bits."""
    import jax.numpy as jnp
    vals = np.random.default_rng(6).normal(size=(3, 5)).astype(np.float32)
    j = jnp.asarray(vals).astype(jnp.bfloat16)
    t = cv.params_from_numpy({"w": np.asarray(j)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))
    bits = cv.params_to_numpy({"w": t})["w"]
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, np.asarray(j).view(np.uint16))
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(bits).view(jnp.bfloat16)), np.asarray(j))


def test_bfloat16_checkpoint_bytes_match_reference(tmp_path):
    """The port writes a bfloat16 leaf as the reference's file, byte for
    byte (descr `<V2`), and reads such a file, or uint16 bits, back into
    a bfloat16 template."""
    import jax.numpy as jnp
    vals = np.random.default_rng(7).normal(size=(4, 6)).astype(np.float32)
    j = jnp.asarray(vals).astype(jnp.bfloat16)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    tckpt.save(str(tmp_path / "t"), 1, {"w": t, "n": {"b": t[0]}})
    jckpt.save(str(tmp_path / "j"), 1, {"w": j, "n": {"b": j[0]}})
    for name in ("w", "n__b", "manifest"):
        ext = ".json" if name == "manifest" else ".npy"
        assert filecmp.cmp(tmp_path / "t" / "step_1" / (name + ext),
                           tmp_path / "j" / "step_1" / (name + ext),
                           shallow=False), name
    like = {"w": torch.zeros(4, 6, dtype=torch.bfloat16),
            "n": {"b": torch.zeros(6, dtype=torch.bfloat16)}}
    for d in ("t", "j"):
        back, _ = tckpt.restore(str(tmp_path / d), like, device="cpu")
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"], t) and torch.equal(back["n"]["b"], t[0])
    np.save(tmp_path / "t" / "step_1" / "w.npy",
            t.view(torch.uint16).numpy())
    back, _ = tckpt.restore(str(tmp_path / "t"), like, device="cpu")
    assert torch.equal(back["w"], t)
