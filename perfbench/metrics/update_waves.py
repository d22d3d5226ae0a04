"""update_waves.update (waves): BHL+'s search and repair waves per batch
over the window, from the program's wave counter (`engine.WAVES`:
`search_improved`, `repair_base` and `repair`), one relax sweep each."""

KINDS = ("search_improved", "repair_base", "repair")


def read(run):
    if run.kind != "update" or not run.ops:
        return None
    return sum(run.waves[k] for k in KINDS) / run.ops
