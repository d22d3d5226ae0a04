"""bound_ms.query (ms): device ms a query microbatch launched under the
program's span `query.bound` (kernel B's min-plus bound and the label
gathers around it), over the second traced stretch (the program's spans
on). A device record counts under the span open at its launch
(`spans.reduce`)."""
from perfbench import spans


def bound_ms(summary: dict, ops: int):
    return spans.device_ms_per_op(summary, ops,
                                  lambda name: name == "query.bound")


def read(run):
    if run.kind != "query" or not run.spans:
        return None
    return bound_ms(run.spans["reduced"], run.spans["ops"])
