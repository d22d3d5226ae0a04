#!/usr/bin/env python3
"""chip_smoke's phase 12 alone: the GNN family and the sampler on one GPU.

    python3 tools/probe_gnn.py            # 12a/b, then 12c
    python3 tools/probe_gnn.py --profile  # only: one step per arch traced

Runs `chip_smoke.run_gnn` (the card against the CPU on `molecule`, then
every arch's train steps on `minibatch_lg` and `molecule`) and
`chip_smoke.run_sampler` on BA(2^20, 4) with the labelling of
`api.build` and one `api.update` of 512 inserts and 512 deletes (phase 3's
graph and post-update labelling; the build compiles kernels A and B),
with the same checks, the kernel launch counts set to 0 before each and
required to read 0 after. With `--profile` it runs instead one train
step of each arch on `minibatch_lg` (after two warm-up steps) under
`torch.profiler`: device-busy ms against the step's host ms and the ten
kernels with the most device time. Prints the card's name and power
limit first and the numbers as one JSON line last. Exits nonzero without
a CUDA device or if a check fails.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke as cs   # first: it sets the allocator's configuration
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_gnn: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    if "--profile" in sys.argv[1:]:
        print(json.dumps(profile_steps(cs, torch, dev, card)))
        return 0
    out = {}
    cs.reset_launches()
    out["gnn"] = cs.run_gnn(torch, np, dev, card)
    if any(cs.read_launches().values()):
        raise AssertionError(f"GNN launches {cs.read_launches()}")
    from repro_torch import api
    from repro_torch.graphs import coo
    from repro_torch.graphs import generators as gen
    edges = gen.barabasi_albert(cs.N, cs.BA_M, seed=0)
    ups = gen.random_batch_updates(edges, cs.N, n_ins=cs.N_INS,
                                   n_del=cs.N_DEL, seed=1)
    g0, lab0 = api.build(cs.N, edges, num_landmarks=cs.LANDMARKS,
                         capacity=cs.CAPACITY, device=dev)
    _, lab1, _ = api.update(g0, lab0, coo.make_batch(
        ups, pad_to=cs.N_INS + cs.N_DEL, device=dev))
    cs.reset_launches()
    out["sampler"] = cs.run_sampler(torch, np, dev, card, edges, lab1)
    if any(cs.read_launches().values()):
        raise AssertionError(f"sampler launches {cs.read_launches()}")
    print(json.dumps(out))
    return 0


def profile_steps(cs, torch, dev, card) -> dict:
    """One traced train step of each arch at full width on minibatch_lg."""
    from repro_torch.configs import common
    from repro_torch.models import gnn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as tts
    out = {}
    for arch in cs.GNN_ARCHS:
        cfg, batch = cs.gnn_cell_batch(
            torch, common.get_arch(arch).model_config(), "minibatch_lg", dev)
        params = gnn.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(0),
            device=dev)
        opt = opt_lib.AdamWConfig(lr=cs.GNN_LR)
        step = tts.make_generic_train_step(
            lambda p, b: gnn.loss_fn(p, b, cfg), opt)
        box = [tts.init_train_state(params, opt)]
        del params
        for _ in range(2):
            box[0], _ = step(box[0], batch)

        def one():
            box[0], _ = step(box[0], batch)
        per, busy, host = cs.device_kernels(torch, one)
        top = dict(sorted(per.items(), key=lambda kv: -kv[1][0])[:10])
        out[arch] = dict(device_busy_ms=busy, host_ms=host,
                         launches=sum(v[1] for v in per.values()), top=top)
        print(f"profile {arch} minibatch_lg ({card}): device busy "
              f"{busy:.2f} ms of {host:.2f} host ms under the profiler, "
              f"{out[arch]['launches']} launches; top {top}", flush=True)
        del box, batch
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
