"""update_p95_ms (ms): the 95th percentile over every batch of the window
of the time from its dispatch (`make_batch`) to its commit: how long a
batch takes to become visible. Host clock."""
import numpy as np


def read(run):
    if run.kind != "update" or not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
