#!/usr/bin/env python3
"""chip_smoke's phase 14 alone: the five BatchHL cells on one GPU.

    python3 tools/probe_batchhl.py

Builds phase 3's state (BA(2^20, 4), capacity 2^23, 32 landmarks through
`api.build`; one `api.update` of 512 inserts and 512 deletes; the 1024
queries in microbatches of 32 at max_steps 64, which compiles kernels A
and B), then runs `chip_smoke.run_batchhl_cells` with its checks: the
cells of `configs/batchhl.py` against phase 3, the COO path and scipy
BFS, their launches, seconds and peak memory, and the dry run's bytes
and FLOPs passes. Prints the card's name and power limit first and the
numbers as one JSON line last. Exits nonzero without a CUDA device or if
a check fails.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke as cs   # first: it sets the allocator's configuration
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_batchhl: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    from repro_torch import api
    from repro_torch.graphs import coo
    from repro_torch.graphs import generators as gen
    t0 = time.perf_counter()
    edges = gen.barabasi_albert(cs.N, cs.BA_M, seed=0)
    ups = gen.random_batch_updates(edges, cs.N, n_ins=cs.N_INS,
                                   n_del=cs.N_DEL, seed=1)
    rng = np.random.default_rng(2)
    qs = rng.integers(0, cs.N, cs.QUERIES).astype(np.int32)
    qt = rng.integers(0, cs.N, cs.QUERIES).astype(np.int32)
    g0, lab0 = api.build(cs.N, edges, num_landmarks=cs.LANDMARKS,
                         capacity=cs.CAPACITY, device=dev)
    batch = coo.make_batch(ups, pad_to=cs.N_INS + cs.N_DEL, device=dev)
    g1, lab1, aff1 = api.update(g0, lab0, batch)
    answers = torch.cat([
        api.query(g1, lab1, qs[i:i + cs.MICROBATCH], qt[i:i + cs.MICROBATCH],
                  max_steps=cs.MAX_STEPS)
        for i in range(0, cs.QUERIES, cs.MICROBATCH)])
    torch.cuda.synchronize()
    print(f"phase 3 state: {time.perf_counter() - t0:.1f} s", flush=True)
    row = cs.run_batchhl_cells(torch, np, dev, card, edges, g0, lab0, batch,
                               (g1, lab1, aff1), answers, qs, qt)
    print(json.dumps(dict(card=card, **row)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
