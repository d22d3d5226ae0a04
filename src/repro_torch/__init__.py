"""BatchHL on PyTorch + CUDA: the port of the `repro` package to one GPU.

The package mirrors `repro`'s layout (`graphs`, `core`, `kernels`,
`checkpoint`, `data`, `launch`, `api`, and of the off-paper zoo `train`,
`models`, `configs`). BatchHL holds itself bit for bit to the reference:
every output is an integer. Two hand-written CUDA kernels (`csrc/`)
carry its paths — the relax sweep behind every wave and the min-plus
query bound. Each has a plain PyTorch version beside it that runs for CPU
tensors. MIND and the optimiser compute in float32 and are held to the
reference within stated tolerances. Nothing compiles at import: kernels
build with `nvcc` at first use (`kernels/build.py`).
"""
