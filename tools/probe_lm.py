#!/usr/bin/env python3
"""chip_smoke's phase 13 alone: the transformer LMs on one GPU.

    python3 tools/probe_lm.py            # phase 13
    python3 tools/probe_lm.py --profile  # only: minitron-4b's cells traced

Runs `chip_smoke.run_lm`: each LM's reduced config in float32 on the
card against the CPU, its full-width config cut to 2 layers in bfloat16
against a float32 recomputation, then at full depth (Mixtral cut to 8 of
its 56 layers) the decode checks, prefill_32k, decode_32k and (DeepSeek)
long_500k, and last 6 train steps of the full minitron-4b at sequence
4096, batch 2, with the same checks, the kernel launch counts set to 0
before and required to read 0 after. No kernel is built. With
`--profile` it traces instead the full minitron-4b (it fits every cell)
under `torch.profiler`: one prefill_32k call, one decode_32k step at
batch 8 on a cache of 32,768 entries, and one train step at batch 2 of
4,096 tokens (after one warm-up step): device-busy ms against host ms,
launches, and the fifteen kernels with the most device time. Prints
the card's name and power limit first and the numbers as one JSON line
last. Exits nonzero without a CUDA device or if a check fails.
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
        print("probe_lm: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    if "--profile" in sys.argv[1:]:
        print(json.dumps(profile_cells(cs, torch, np, dev, card)))
        return 0
    cs.reset_launches()
    out = cs.run_lm(torch, np, dev, card)
    out["launches"] = cs.read_launches()
    if any(out["launches"].values()):
        raise AssertionError(f"LM launches {out['launches']}")
    print(json.dumps(out))
    return 0


def profile_cells(cs, torch, np, dev, card) -> dict:
    """minitron-4b's prefill_32k, decode_32k and train_4k cells, one call
    of each traced."""
    from repro_torch.configs import common
    from repro_torch.launch.train import synth_lm_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import serve_step as ss
    from repro_torch.train import train_step as tts
    cfg = cs.lm_config(cs.LM_TRAIN_ARCH)
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    out = {}

    def report(name, fn):
        per, busy, host = cs.device_kernels(torch, fn)
        top = dict(sorted(per.items(), key=lambda kv: -kv[1][0])[:15])
        out[name] = dict(device_busy_ms=busy, host_ms=host,
                         launches=sum(v[1] for v in per.values()), top=top)
        print(f"profile {cs.LM_TRAIN_ARCH} {name} ({card}): device busy "
              f"{busy:.2f} ms of {host:.2f} host ms under the profiler, "
              f"{out[name]['launches']} launches; top {top}", flush=True)

    seq = common.LM_SHAPES["prefill_32k"]["seq"]
    rng = np.random.default_rng(17)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, seq)).astype(
        np.int32)).to(dev)
    box = [ss.make_cache(cfg, 1, seq, device=dev)]
    report("prefill_32k", lambda: ss.make_prefill_step(cfg)(
        params, box[0], toks))
    box[0] = ss.make_cache(cfg, 8, seq + 512, device=dev)
    cs.fill_cache(torch, box[0], seq, torch.Generator(
        device=dev).manual_seed(1))
    tok = toks[:, :8].reshape(8, 1)
    decode = ss.make_decode_step(cfg)
    decode(params, box[0], tok, seq)
    report("decode_32k", lambda: decode(params, box[0], tok, seq + 1))
    del box[0]
    torch.cuda.empty_cache()
    opt = opt_lib.AdamWConfig()
    state = [tts.init_train_state(params, opt)]
    del params
    batch = synth_lm_batch(0, cs.LM_TRAIN_BATCH,
                           common.LM_SHAPES["train_4k"]["seq"], cfg.vocab,
                           device=dev)
    step = tts.make_lm_train_step(cfg, opt)
    step(state[0], batch)

    def one():
        step(state[0], batch)
    report("train_4k", one)
    return out


if __name__ == "__main__":
    sys.exit(main())
