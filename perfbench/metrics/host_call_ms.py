"""host_call_ms.<entry>: the host's wall time inside the call, until it
returns and before its result is read, the mean over the window's calls,
from the benchmark's clock around the call."""


def read(run, part):
    if run.entry != part or not run.calls:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in run.calls) / len(run.calls)
