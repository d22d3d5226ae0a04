"""host_syncs.query / .update (reads): the program's host reads of
device values per op (a query microbatch or an update batch) over the
window of a traced run, from its counter `repro_torch.trace.HOST_READS`
read around each op. Each read waits for the device: a BiBFS wave and
one to stop a microbatch, a search or repair wave and one in `prepare` a
batch. Fewer reads, fewer stalls of the host's launches."""


def host_syncs(per_op: list):
    """Mean reads an op of records that carry `reads`, or None."""
    reads = [r["reads"] for r in per_op if "reads" in r]
    if not reads or len(reads) != len(per_op):
        return None
    return sum(reads) / len(reads)


def read(run):
    return host_syncs(run.per_op)
