"""call_p95_ms: the 95th percentile of the latency of every call the timed
window completed, from handing the host arrays to the entry until its
tokens are on the host (host clock; linear interpolation between order
statistics, numpy's default)."""

import numpy as np


def read(trace, run):
    if not run.latencies:
        return None
    return float(np.quantile(np.asarray(run.latencies, dtype=np.float64), 0.95)) * 1e3
