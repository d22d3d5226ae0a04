"""prepare_ms.update (ms): the mean host time per batch of
`RelaxEngine.prepare` (fingerprint, cover check and, on a retile, the
host tiling) over the window. Host clock around the call."""


def read(run):
    if run.kind != "update" or not run.prepare_s:
        return None
    return 1e3 * sum(run.prepare_s) / len(run.prepare_s)
