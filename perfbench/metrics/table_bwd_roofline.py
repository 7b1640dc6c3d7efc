"""table_bwd_roofline.<entry>: the least time of a step's backward past 64
surfaces on the H100 (counts/tables.py: K6's cache, the upstream gradient
and the radiance read once, the row tags and the per-row gradients written
once, at the HBM peak) over the device milliseconds of the call's
`kytpu::launch.k7`, `kytpu::launch.tag_sort` and
`kytpu::launch.segment_sums` spans, in %, from the program's spans in the
traced window."""

from perfbench.metrics import _spans
from perfbench.metrics.transport_roofline import PEAKS

LAUNCHES = ("k7", "tag_sort", "segment_sums")


def read(run, part):
    got = _spans.window(run, part)
    if got is None or not run.work or "bwd_bytes" not in run.work:
        return None
    recs, entries = got
    idx = [i for k in LAUNCHES
           for i in _spans.outermost(recs, entries, _spans.LAUNCH + k)
           if recs[i].name == _spans.LAUNCH + k]
    ms = _spans.device_ms(recs, idx)
    least = run.work["bwd_bytes"] / PEAKS["hbm_bytes_s"]
    if not ms or least <= 0:
        return None
    return 100.0 * least / (1e-3 * ms / len(entries))
