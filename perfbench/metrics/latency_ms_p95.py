"""latency_ms_p95: the 95th percentile of the wall time of every call of
the window, from the call to its result on the host."""

import numpy as np


def read(run, part=None):
    if not run.calls:
        return None
    walls = [(done - start) * 1e3 for start, _, done in run.calls]
    return float(np.percentile(walls, 95))
