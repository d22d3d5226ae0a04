"""update_rate (updates/s): every update row committed in the window over
the window's seconds, from its start to the commit of its last batch
(`batchhl_update` returned and the device synchronised). Host clock."""


def read(run):
    if run.kind != "update" or run.window_s <= 0:
        return None
    return run.items / run.window_s
