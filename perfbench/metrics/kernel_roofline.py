"""kernel_roofline.<entry>: the least time of a call's light transport on
the H100 (as transport_roofline counts it: its FP32 operations at the FP32
peak or its bytes at the HBM peak, whichever is longer) over the device
time of the call's kernels alone, in %: the device milliseconds of the
`kytpu::launch.*` spans (each launch of K1-K8, the tag sort and the
segment sums, timed by CUDA events on its stream right at the launch, so
without its dispatch wrapper's argument packing), from the program's spans
in the traced window."""

from perfbench.metrics import _spans
from perfbench.metrics.transport_roofline import PEAKS


def read(run, part):
    got = _spans.window(run, part)
    if got is None or not run.work:
        return None
    recs, entries = got
    ms = _spans.device_ms(recs, _spans.outermost(recs, entries,
                                                 _spans.LAUNCH))
    least = max(run.work["fp32_ops"] / PEAKS["fp32_flop_s"],
                run.work["bytes"] / PEAKS["hbm_bytes_s"])
    if not ms or least <= 0:
        return None
    return 100.0 * least / (1e-3 * ms / len(entries))
