"""query_rate (queries/s): every query answered in the window over the
window's seconds, from its start to the answers of its last microbatch
on the host. Host clock."""


def read(run):
    if run.kind != "query" or run.window_s <= 0:
        return None
    return run.items / run.window_s
