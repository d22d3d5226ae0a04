"""A run with the timed path broken underneath reads `correct` false:
once for each fault that a cell can have. (The cells run on one chip, so
no exchange between chips can be left out.)"""
from __future__ import annotations

import dataclasses

import pytest

from perfbench import harness
from perfbench.conftest import small_cell


class Broken(harness.Program):
    """The program with one of its calls broken."""

    def __init__(self, fault: str):
        super().__init__()
        self.fault = fault
        self.calls = 0
        query, update, batch = (self.batched_query, self.batchhl_update,
                                self.make_batch)

        def batched_query(g, lab, s, t, **kw):
            if fault == "half_microbatch_left_out":
                half = s.shape[0] // 2
                d = query(g, lab, s[:half], t[:half], **kw)
                return d.new_full(s.shape, 1 << 28).index_copy_(
                    0, s.new_tensor(range(half)).long(), d)
            d = query(g, lab, s, t, **kw)
            if fault == "answer_altered":
                d = d.clone()
                d[0] += 1
            return d

        def batchhl_update(g_old, b, lab, **kw):
            self.calls += 1
            g2, lab2, aff = update(g_old, b, lab, **kw)
            if fault == "state_unchanged":
                return g_old, lab, aff
            if fault == "labelling_unchanged":
                return g2, lab, aff
            if fault == "label_altered":
                dist = lab2.dist.clone()
                dist[0, self.calls % dist.shape[1]] += 1
                return g2, dataclasses.replace(lab2, dist=dist), aff
            return g2, lab2, aff

        def make_batch(rows, **kw):
            if fault == "half_batch_left_out":
                rows = rows[:len(rows) // 2]
            return batch(rows, **kw)

        self.batched_query = batched_query
        self.batchhl_update = batchhl_update
        self.make_batch = make_batch


QUERY = ["answer_altered", "half_microbatch_left_out"]
UPDATE = ["state_unchanged", "labelling_unchanged", "label_altered",
          "half_batch_left_out"]


@pytest.mark.parametrize("workload,fault",
                         [("ba20.query", f) for f in QUERY]
                         + [("kron20.query", f) for f in QUERY]
                         + [("ba20.update_del", f) for f in UPDATE]
                         + [("kron20.update_del", UPDATE[0])])
def test_a_broken_program_reads_not_correct(workload, fault, cpu):
    cell = small_cell(workload)
    result, _ = harness.run_cell(cell, 2**32 + 3, 0.4, False, cpu,
                                 prog=Broken(fault))
    assert result["correct"] is False
    assert result["failed"] > 0


def test_the_unbroken_program_reads_correct(cpu):
    result, _ = harness.run_cell(small_cell("ba20.update_del"), 2**32 + 3,
                                 0.4, False, cpu, prog=Broken("none"))
    assert result["correct"] is True
