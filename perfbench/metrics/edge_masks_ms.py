"""edge_masks_ms.update (ms): device ms an update batch launched under
the program's span `bhl.edge_masks` (the repair's [R, E2] boundary and
interior edge masks, gathered from the affected planes over every slot),
over the second traced stretch (the program's spans on)."""
from perfbench import spans


def edge_masks_ms(summary: dict, ops: int):
    return spans.device_ms_per_op(summary, ops,
                                  lambda name: name == "bhl.edge_masks")


def read(run):
    if run.kind != "update" or not run.spans:
        return None
    return edge_masks_ms(run.spans["reduced"], run.spans["ops"])
