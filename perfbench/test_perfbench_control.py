"""The control of each cell's check fails it, while the program passes:
the reference in the program's place, broken in the guarantee the
configurations state (exact distances; a labelling exact after every
committed batch). Kept at a size a test holds; on the card
`perfbench/control.py` reads it at each cell's own size."""
from __future__ import annotations

import pytest

from perfbench import control
from perfbench.conftest import small_cell, workloads


@pytest.mark.parametrize("workload", workloads())
def test_the_control_fails_the_check_and_the_program_passes(workload, cpu):
    sides = dict(control.readings(small_cell(workload), 2**31 + 99, 0.4,
                                  cpu))
    numbers = [k for k, v in sides["program"].items()
               if isinstance(v, tuple)]
    assert all(sides["program"][k][0] <= sides["program"][k][1]
               for k in numbers)
    assert any(sides["control"][k][0] > sides["control"][k][1]
               for k in numbers)
