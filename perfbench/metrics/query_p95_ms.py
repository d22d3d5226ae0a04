"""query_p95_ms (ms): the 95th percentile over every query of the window
of its latency, that of its microbatch: from the host's dispatch (the
endpoints' copy to the device) to the answers back on the host. Every
microbatch holds as many queries, so this is the percentile over the
microbatches. Host clock."""
import numpy as np


def read(run):
    if run.kind != "query" or not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
