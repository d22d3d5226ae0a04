"""plane_ms.query (ms): device ms a query microbatch launched under the
program's span `query.bibfs` other than kernel A's kernels
(`relax_roofline.kernel_of`): the query plane's own torch ops (the
waves' selects, minima, adds and counts, the seeding and the stop test),
over the second traced stretch (the program's spans on)."""
from perfbench import harness, spans


def plane_ms(summary: dict, ops: int):
    kernel_of = harness.load_module(
        harness.metric_path("relax_roofline")).kernel_of
    return spans.device_ms_per_op(
        summary, ops, lambda name: name == "query.bibfs",
        lambda kernel: not kernel_of(kernel))


def read(run):
    if run.kind != "query" or not run.spans:
        return None
    return plane_ms(run.spans["reduced"], run.spans["ops"])
