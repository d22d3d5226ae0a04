"""retiles.update (retiles): host tilings per batch over the window, from
the engine's `retile_count`. A deletion-only batch keeps every live slot
tiled, so the serve loop vouches for the plan and this reads 0."""


def read(run):
    if run.kind != "update" or not run.ops:
        return None
    return run.retiles / run.ops
