"""Cap torch's intra-op threads per pytest-xdist worker.

Test support, not a test module: every `tests/test_torch_*.py` imports it
first, so the cap holds whichever file a worker collects first. Each xdist
worker would otherwise give torch one thread per core, and with several
workers on one box those threads thrash: a body that takes about 13 s
with one thread per worker takes minutes with one per core. The cap is
the worker's share of the cores it may run on, at least one. Without
xdist (`PYTEST_XDIST_WORKER_COUNT` unset) it does nothing.

It changes no test's data, seed, size, tolerance or check. Float sums may
add up in another order with fewer threads; the float tests hold
tolerances for that, and the integer ones are exact at any thread count.
"""
from __future__ import annotations

import os

import torch

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    torch.set_num_threads(
        max(1, len(os.sched_getaffinity(0)) // max(1, int(_workers))))
