"""Fault-tolerant LM training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \
        --steps 100 --ckpt-dir build/lm_ckpt --ckpt-every 20 [--device cpu]

The port of `repro.launch.train`. Runs the arch's reduced config unless
`--full` is given; `--full` runs only where the params, their gradients
and the optimiser's float32 moments fit in the device's memory (and
says so, exiting 2, where they do not). Stateless-seeded data
(`synth_lm_batch`, the reference's batches bit for bit), the port's
train step, and checkpoint/restart through `checkpoint/manager.py`:
kill it mid-run and run it again, and it resumes from the newest
checkpoint exactly. Without `--device` it trains on the GPU and raises
where there is none. Params start from `init_params` on a generator
seeded 0 on the device (the reference's come from JAX's PRNG).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import common as cc
from repro_torch.device import resolve_device
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib
from repro_torch.tree import tree_leaves


def synth_lm_batch(step: int, batch: int, seq: int, vocab: int, *,
                   device: str | torch.device | None = None) -> dict:
    """{tokens, targets} [batch, seq] int32 drawn from
    `default_rng(step)` as the reference draws them (stateless: batch =
    f(step)), on the GPU unless `device` says otherwise."""
    rng = np.random.default_rng(step)
    toks = rng.integers(0, vocab, size=(batch, seq + 1)).astype(np.int32)
    dev = resolve_device(device)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "targets": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


def state_bytes(cfg, opt_cfg: opt_lib.AdamWConfig) -> int:
    """Bytes of the params, their gradients and the optimiser's float32
    state (m, v and, with int8_ef, ef), activations not counted."""
    from repro_torch.models import transformer as tfm
    per = 8 + (4 if opt_cfg.compress == "int8_ef" else 0)
    return sum(p.numel() * (2 * p.element_size() + per)
               for p in tree_leaves(tfm.param_shapes(cfg)))


def device_bytes(dev: torch.device) -> int:
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="build/lm_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="use the full (published-width) config")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the GPU)")
    args = ap.parse_args(argv)

    mod = cc.get_arch(args.arch)
    if mod.FAMILY != "lm":
        raise SystemExit("train.py drives LM archs")
    cfg = mod.model_config() if args.full else mod.reduced_config()
    dev = resolve_device(args.device)
    opt_cfg = opt_lib.AdamWConfig(
        lr=args.lr, compress="int8_ef" if args.compress_grads else None)
    if args.full:
        need, have = state_bytes(cfg, opt_cfg), device_bytes(dev)
        if need > have:
            print(f"{args.arch} --full does not fit on {dev}: its params, "
                  f"gradients and optimiser state take {need / 1e9:.1f} GB "
                  f"of {have / 1e9:.1f} GB, activations not counted")
            raise SystemExit(2)

    from repro_torch.models import transformer as tfm
    step_fn = ts_lib.make_lm_train_step(cfg, opt_cfg)
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    state = ts_lib.init_train_state(params, opt_cfg)
    start = ckpt.latest_step(args.ckpt_dir)
    if start is not None:
        state, start = ckpt.restore(args.ckpt_dir, state, device=dev)
        print(f"resumed from step {start}")
    else:
        start = 0
        print("fresh start")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = synth_lm_batch(step, args.batch, args.seq, cfg.vocab,
                               device=dev)
        state, aux = step_fn(state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(aux['loss']):.4f} "
                  f"({time.time() - t0:.1f}s)")
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            path = ckpt.save(args.ckpt_dir, step + 1, state)
            ckpt.prune(args.ckpt_dir, keep=3)
            print(f"checkpoint -> {path}")
    print("done")


if __name__ == "__main__":
    main()
