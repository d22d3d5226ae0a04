#!/usr/bin/env python3
"""chip_smoke's phase 11 alone: MIND and the training substrate on one GPU.

    python3 tools/probe_mind.py

Runs `chip_smoke.run_mind` and nothing else (no kernel build, no BatchHL
phase): the card against the CPU at the medium size, 8 + 2 full-width
train steps and the three full-width serve shapes, with the same checks.
Prints the card's name and power limit first and the phase's numbers as
one JSON line last. Exits nonzero without a CUDA device or if a check
fails.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke   # first: it sets the allocator's configuration
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_mind: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    out = chip_smoke.run_mind(torch, np, torch.device("cuda"), card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
