"""tables_ms.<entry>: host milliseconds a call inside the outermost
`kytpu::tables.*` spans (the geometry tables packed, the colour tables of
each pass or step), waits for the device's queue at their synchronising
copies included; from the program's spans in the traced window."""

from perfbench.metrics import _spans


def read(run, part):
    got = _spans.window(run, part)
    if got is None:
        return None
    recs, entries = got
    idx = _spans.outermost(recs, entries, _spans.TABLES)
    return sum(recs[i].host_ms for i in idx) / len(entries)
