"""The benchmark of the PyTorch and CUDA port of BatchHL (`repro_torch`).

    python3 perfbench/run.py --workload ba20.query --seed 7 --seconds 20 \
        --trace 0

Its cells, metrics and bounds are listed in `BENCHMARK.json` at the root
of the repository; `harness.py` says how a run goes.
"""
