"""host_syncs.<entry>: synchronising CUDA operations a call (copies that
wait for the stream, synchronises, `.item()`), counted by torch's sync
debug mode inside the entry span; from the program's spans in the traced
window."""

from perfbench.metrics import _spans


def read(run, part):
    got = _spans.window(run, part)
    if got is None:
        return None
    recs, entries = got
    if recs[entries[0]].device_ms is None:
        return None     # no CUDA: nothing was counted
    calls = set(entries)
    n = sum(r.syncs for i, r in enumerate(recs)
            if i in calls or not calls.isdisjoint(_spans.ancestors(recs, i)))
    return n / len(entries)
