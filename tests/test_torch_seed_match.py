"""The seed weights' slot match (`repro_torch/kernels/seed_match`) on the CPU.

The plain version against a loop over the slots, in both key kinds, with
repeated keys, parallel and dead slots and vertex ids near 2^31 − 1; the
launch geometry of `csrc/seed_match.cu` (shared or device memory for the
keys, shared memory and CTAs within the card's limits); and the checks
that run before any device dispatch. The kernel itself runs in
`tests/test_torch_cuda.py` on the card.
"""
from __future__ import annotations

import _torch_threads  # noqa: F401  (first: caps torch's threads per worker)

import numpy as np
import pytest
import torch

from repro_torch.kernels.seed_match import kernel as sk
from repro_torch.kernels.seed_match import ops as sops

H100_SMS = 132


def _slots(seed: int, e2: int, n: int, hi: bool):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e2)
    dst = rng.integers(0, n, e2)
    if hi:
        src, dst = 2**31 - 1 - src, 2**31 - 1 - dst
    w = rng.integers(1, 100, e2).astype(np.int32)
    valid = rng.random(e2) < 0.6
    return src.astype(np.int32), dst.astype(np.int32), valid, w


def _loop(src, dst, valid, w, keys, key):
    """acc by a loop over the slots: the max live weight at each key's
    first sorted position."""
    first = {}
    for p, k in enumerate(keys.tolist()):
        first.setdefault(k, p)
    acc = np.zeros(len(keys), np.int32)
    for a, b, ok, x in zip(src.tolist(), dst.tolist(), valid, w):
        lo, hi = (min(a, b), max(a, b)) if key == "pair" else (a, b)
        p = first.get(lo * 2**32 + hi)
        if ok and p is not None:
            acc[p] = max(acc[p], x)
    return acc


@pytest.mark.parametrize("hi", [False, True])
@pytest.mark.parametrize("key", sk.KEYS)
@pytest.mark.parametrize("u", [1, 7, 64])
def test_seed_match_plain_equals_a_loop(u, key, hi):
    src, dst, valid, w = _slots(u, 600, 12, hi)
    rng = np.random.default_rng(u + 1)
    pick = rng.integers(0, 600, u)
    keep = torch.from_numpy(rng.random(u) < 0.8)
    t = [torch.from_numpy(a) for a in (src, dst, valid, w)]
    rows = sk.slot_key(t[0][pick], t[1][pick], key, keep)
    keys, _ = torch.sort(rows)
    acc = sk.seed_match(*t, keys, key)
    assert acc.dtype == torch.int32 and acc.shape == (u,)
    np.testing.assert_array_equal(
        acc.numpy(), _loop(src, dst, valid, w, keys.numpy(), key))
    np.testing.assert_array_equal(
        sops.max_live_weight(*t, rows, key).numpy(),
        acc[torch.searchsorted(keys, rows)].numpy())


def test_slot_key_kinds():
    a = torch.tensor([3, 5, 2**31 - 1], dtype=torch.int32)
    b = torch.tensor([5, 3, 0], dtype=torch.int32)
    assert sk.slot_key(a, b, "pair").tolist() == [
        3 * 2**32 + 5, 3 * 2**32 + 5, 2**31 - 1]
    assert sk.slot_key(a, b, "arc").tolist() == [
        3 * 2**32 + 5, 5 * 2**32 + 3, (2**31 - 1) * 2**32]
    keep = torch.tensor([True, False, True])
    assert sk.slot_key(a, b, "arc", keep)[1] == -(2**32) - 1


@pytest.mark.parametrize("u,shared", [(1, True), (1024, True),
                                      (10_240, True), (40_000, False),
                                      (sk.SEED_MATCH_MAX_SHARED_KEYS, True),
                                      (sk.SEED_MATCH_MAX_SHARED_KEYS + 1,
                                       False)])
@pytest.mark.parametrize("e2", [8, 2**24, 2**25 + 6])
def test_seed_match_geometry(u, shared, e2):
    """Keys in shared memory up to the opt-in limit beside the filter,
    else in device memory; every CTA fits an SM, no more CTAs than the
    SMs keep at once or than the slots need."""
    geo = sk.seed_match_geometry(u, e2, H100_SMS)
    assert geo.shared_keys == shared and geo.vec
    assert geo.smem_bytes == sk.SEED_MATCH_FILTER_BYTES + 8 * u * shared
    assert geo.smem_bytes <= sk.SEED_MATCH_CTA_SHARED
    per_sm = sk.SEED_MATCH_SM_SHARED // (geo.smem_bytes
                                        + sk.SEED_MATCH_CTA_RESERVED)
    assert 1 <= geo.blocks <= H100_SMS * min(per_sm,
                                             sk.SEED_MATCH_CTAS_PER_SM)
    assert geo.blocks <= max(1, -(-(e2 // 4) // sk.SEED_MATCH_THREADS))
    unaligned = sk.seed_match_geometry(u, e2, H100_SMS, aligned=False)
    assert not unaligned.vec and unaligned.blocks >= geo.blocks


def test_seed_match_geometry_at_the_update_cells():
    """U = 1,024 over `ba20`'s and `kron20`'s slots: keys and filter in 40
    KB of shared memory, four CTAs on each SM."""
    for e2 in (2**24, 2**25):
        geo = sk.seed_match_geometry(1024, e2, H100_SMS)
        assert geo == sk.SeedMatchGeometry(shared_keys=True,
                                           smem_bytes=40_960,
                                           blocks=4 * H100_SMS, vec=True)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_seed_match_unknown_key_raises_before_dispatch(device):
    """The key kind is checked before the device is: a CUDA call with an
    unknown kind raises just as these do, and launches nothing."""
    t = [torch.zeros(4, dtype=dt, device=device)
         for dt in (torch.int32, torch.int32, torch.bool, torch.int32)]
    keys = torch.zeros(2, dtype=torch.int64, device=device)
    before = sk.launches
    for key in ("both", "", None, 0):
        with pytest.raises(ValueError, match="key must be one of"):
            sk.seed_match(*t, keys, key)
    with pytest.raises(ValueError, match="key must be one of"):
        sk.slot_key(t[0], t[1], "undirected")
    assert sk.launches == before


def test_seed_match_rejects_bad_inputs():
    t = [torch.zeros(4, dtype=dt)
         for dt in (torch.int32, torch.int32, torch.bool, torch.int32)]
    keys = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="U >= 1"):
        sk.seed_match(*t, keys[:0], "pair")
    with pytest.raises(ValueError, match="int64"):
        sk.seed_match(*t, keys.to(torch.int32), "pair")
    with pytest.raises(ValueError, match="w must be"):
        sk.seed_match(*t[:3], t[3].to(torch.int64), keys, "pair")
    with pytest.raises(ValueError, match="no seed_match kernel"):
        sk.seed_match(*(x.to("meta") for x in t), keys.to("meta"), "pair")
