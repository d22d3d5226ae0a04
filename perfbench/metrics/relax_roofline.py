"""relax_roofline.query / .update (%): kernel A's share of its roofline
over the traced span: the least time its waves need (their bytes by
`roofline.wave_bytes`, over the card's memory bandwidth) over the device
time of kernel A's kernels in the profiler's trace.

Kernel A is the wrapper `kernels/edge_relax/kernel.relax_sweep` and the
kernels it launches, named below. (`fill_chunked_kernel` and
`fill_inf_kernel` are also names in kernel C's source; kernel C does not
run on the serving path.) Where the profiler lost records of some sweeps
(it now and then loses whole calls), the bytes are taken for the sweeps
it recorded.
"""
import re

from perfbench import roofline

KERNELS = ("relax_sweep_kernel", "transpose_kernel", "fill_chunked_kernel",
           "fill_inf_kernel", "pack_mask_kernel")
# A record's name is the kernel's demangled signature, as
# "void (anonymous namespace)::relax_sweep_kernel<false>(int const*, ...)".
_NAME = re.compile(r"(?:^|\s|\(anonymous namespace\)::)("
                   + "|".join(KERNELS) + r")\s*[<(]")


def kernel_of(name: str):
    """The kernel-A kernel a device record's name is, or None."""
    m = _NAME.search(name)
    return m.group(1) if m else None


def read(run):
    traced = run.traced or {}
    summary = traced.get("summary") or {}
    secs = swept = 0
    for name, (s, count) in summary.get("kernels", {}).items():
        which = kernel_of(name)
        if which:
            secs += s
            swept += count if which == "relax_sweep_kernel" else 0
    if secs <= 0 or not traced.get("bytes") or not traced.get("launches"):
        return None
    nbytes = traced["bytes"] * min(1.0, swept / traced["launches"])
    return 100 * roofline.least_seconds(nbytes) / secs
