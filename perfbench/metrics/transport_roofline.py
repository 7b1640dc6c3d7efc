"""transport_roofline.<entry>: the least time of a call's light transport
on the H100 (its FP32 operations at the FP32 peak or its bytes at the HBM
peak, whichever is longer; counts/transport.py from the reference's lanes)
over the call's device busy time in the traced window, in %. Its
denominator is all the busy time, whatever kernels carry the work."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1]
                    / "peaks.json").read_text())


def read(run, part):
    if run.entry != part or run.profile is None or not run.work:
        return None
    least = max(run.work["fp32_ops"] / PEAKS["fp32_flop_s"],
                run.work["bytes"] / PEAKS["hbm_bytes_s"])
    busy = run.profile.busy_s / run.profile.calls
    return 100.0 * least / busy if least > 0 and busy > 0 else None
