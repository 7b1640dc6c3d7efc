"""table_fwd_roofline.<entry>: the least time of a step's forward past 64
surfaces on the H100 (counts/tables.py from the reference's own K6 cache:
a row test a traced lane-bounce, the shading and NEE of each hit, a row
test a shadow ray that reached its light, at the FP32 peak; or K6's cache
written once at the HBM peak, whichever is longer; never the sweeps over
rows, so it stays a lower bound whatever search a kernel runs) over the
device milliseconds of the call's `kytpu::launch.k6` spans, in %, from the
program's spans in the traced window."""

from perfbench.metrics import _spans
from perfbench.metrics.transport_roofline import PEAKS


def read(run, part):
    got = _spans.window(run, part)
    if got is None or not run.work or "fwd_ops" not in run.work:
        return None
    recs, entries = got
    ms = _spans.device_ms(recs, _spans.outermost(
        recs, entries, _spans.LAUNCH + "k6"))
    least = max(run.work["fwd_ops"] / PEAKS["fp32_flop_s"],
                run.work["fwd_bytes"] / PEAKS["hbm_bytes_s"])
    if not ms or least <= 0:
        return None
    return 100.0 * least / (1e-3 * ms / len(entries))
