"""Run one cell of the benchmark on one CUDA device and print its line.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

One run is one process: set-up, a window of `--seconds`, the check
against the plain reference, and as the last line of standard output one
JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`,
traced `breakdown`, and last the numbers compared beside their limits,
`checks`, which also end standard error). Without a CUDA device it exits
2 and prints no result. It needs the checkout around it: the program
under test is `src/repro_torch`.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Caches of anything the run builds stay in the checkout.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    # The checkout's root (for `perfbench`) and the program's source,
    # in place of this file's folder.
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    imported = time.perf_counter()
    return harness.main(args.workload, args.seed, args.seconds,
                        bool(args.trace), t0=T0, imported=imported)


if __name__ == "__main__":
    sys.exit(main())
