"""BatchHL on PyTorch + CUDA: the port of the `repro` package to one GPU.

The package mirrors `repro`'s layout (`graphs`, `core`, `kernels`,
`checkpoint`, `data`, `launch`, `api`) and holds itself bit for bit to
it: every output is an integer. Two hand-written CUDA kernels (`csrc/`)
carry every path — the relax sweep behind every wave and the min-plus
query bound. Each has a plain PyTorch version beside it that runs for CPU
tensors. Nothing compiles at import: kernels build with `nvcc` at first
use (`kernels/build.py`).
"""
