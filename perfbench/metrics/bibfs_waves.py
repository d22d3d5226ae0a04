"""bibfs_waves.query (waves): bidirectional-search waves per microbatch
over the window, from the program's wave counter (`engine.WAVES["bibfs"]`,
one relax sweep each). Fewer waves per microbatch, less work per query."""


def read(run):
    if run.kind != "query" or not run.ops:
        return None
    return run.waves["bibfs"] / run.ops
