"""Kernel A's yardstick against hand counts, and the readers of the
traced span (roofline share, idle share, the span's reduction)."""
from __future__ import annotations

import types

import pytest
import torch

from perfbench import harness, roofline, tracing


def reader(name):
    return harness.load_module(harness.metric_path(name))


def test_wave_bytes_equal_a_hand_count():
    # 2 planes of 4 vertices, 6 live directed edges (3 undirected).
    keys = 2 * 2 * 4 * 4            # read and written, int32
    shared = keys + 6 * 8 + 6 * 1 + 6 * 4
    assert roofline.wave_bytes(2, 4, 6, hub=False) == shared
    assert roofline.wave_bytes(2, 4, 6, hub=True) == shared + 2 * 4
    # A mask per plane, 5 of the 6 edges let through by some plane.
    assert roofline.wave_bytes(2, 4, 6, hub=True, mask_planes=2,
                               used=5) == keys + 8 + 48 + 12 + 20


def test_repair_masks_used_equal_a_hand_count():
    # Path 0-1-2-3 as slot pairs, and one free slot pair at the end.
    src = torch.tensor([0, 1, 1, 2, 2, 3, 0, 0], dtype=torch.int32)
    dst = torch.tensor([1, 0, 2, 1, 3, 2, 0, 0], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.bool)
    aff = torch.tensor([[0, 0, 1, 1], [0, 0, 0, 0]], dtype=torch.bool)
    # Boundary (src unaffected, dst affected): 1->2. Interior: 2->3, 3->2.
    assert roofline.repair_masks_used(valid, src, dst, aff) == (1, 2)
    aff2 = torch.tensor([[0, 0, 1, 1], [1, 0, 0, 0]], dtype=torch.bool)
    assert roofline.repair_masks_used(valid, src, dst, aff2, chunk=1) \
        == (2, 2)


def run_with(summary, nbytes=3.35e9, launches=10):
    return types.SimpleNamespace(traced={"summary": summary,
                                         "bytes": nbytes,
                                         "launches": launches})


KERNEL_A = "void (anonymous namespace)::relax_sweep_kernel<false>(int const*)"
TRANSPOSE = "(anonymous namespace)::transpose_kernel(int const*, int*, int)"
OTHER = "void at::native::transpose_kernel<int>(int const*)"


def test_relax_roofline_reads_kernel_a_alone():
    read = reader("relax_roofline.query").read
    summary = {"kernels": {KERNEL_A: [0.008, 10], TRANSPOSE: [0.002, 10],
                           OTHER: [5.0, 3]}}
    # 3.35e9 bytes need 1 ms; kernel A took 10 ms.
    assert read(run_with(summary)) == pytest.approx(10.0)
    # Records of 2 sweeps lost: the bytes of the 8 recorded ones.
    summary["kernels"][KERNEL_A] = [0.008, 8]
    assert read(run_with(summary)) == pytest.approx(8.0)
    assert read(run_with({"kernels": {OTHER: [1.0, 1]}})) is None
    assert read(types.SimpleNamespace(traced=None)) is None


def test_idle_share_reads_the_span():
    read = reader("idle_share.update").read
    run = types.SimpleNamespace(traced={"summary": {"window_s": 2.0,
                                                    "busy_s": 1.5}})
    assert read(run) == pytest.approx(25.0)
    run.traced["summary"]["busy_s"] = 0.0
    assert read(run) is None


class FakeEvent:
    def __init__(self, name, dev, start_s, end_s, annotation=False):
        self._n, self._d = name, dev
        self._s, self._e, self._a = start_s, end_s, annotation

    def name(self):
        return self._n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._d
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int((self._e - self._s) * 1e9)

    def is_user_annotation(self):
        return self._a


def fake_prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_summarize_unions_busy_time_and_charges_gaps_to_spans():
    ev = [FakeEvent("prepare", False, 0.0, 1.0),
          FakeEvent("batchhl_update", False, 1.0, 3.0),
          FakeEvent("sync", False, 3.0, 4.0),
          FakeEvent("batchhl_update", True, 1.2, 3.5, annotation=True),
          FakeEvent(KERNEL_A, True, 0.5, 1.5),
          FakeEvent(TRANSPOSE, True, 1.0, 2.0),     # overlaps the sweep
          FakeEvent("Memcpy DtoH", True, 3.5, 3.8),
          FakeEvent("aten::add", False, 0.1, 0.2)]
    s = tracing.summarize(fake_prof(ev))
    assert s["window_s"] == pytest.approx(4.0)
    assert s["busy_s"] == pytest.approx(1.5 + 0.3)
    assert s["kernels"][KERNEL_A][0] == pytest.approx(1.0)
    assert "batchhl_update" not in s["kernels"]
    # Gaps: 0-0.5 (prepare), 2.0-3.5 (batchhl_update), 3.8-4.0 (sync).
    assert s["idle"]["prepare"] == pytest.approx(0.5)
    assert s["idle"]["batchhl_update"] == pytest.approx(1.5)
    assert s["idle"]["sync"] == pytest.approx(0.2)
