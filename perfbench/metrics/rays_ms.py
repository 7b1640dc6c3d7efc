"""rays_ms.<entry>: device milliseconds a call of the `kytpu::rays` spans
(the camera jitter's threefry draws and generate_rays, each pass or step),
between each span's CUDA events; from the program's spans in the traced
window."""

from perfbench.metrics import _spans


def read(run, part):
    got = _spans.window(run, part)
    if got is None:
        return None
    recs, entries = got
    ms = _spans.device_ms(recs, _spans.outermost(recs, entries,
                                                 "kytpu::rays"))
    return None if ms is None else ms / len(entries)
