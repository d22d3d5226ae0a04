"""setup_s (s): from the start of the run's program to the end of its
warm-up: imports, the graph from the seed, the snapshot, the host tiling,
the labelling's construction, the stream, one op of the cell's shape
(and the first run in a checkout, the kernels' build). Host clock."""


def read(run):
    return run.setup_s
