"""autograd_ms.<entry>: device milliseconds a step of autograd and the
optimizer: the `kytpu::autograd.backward` span less the outermost
`kytpu::kernel.*` spans inside it (the backward kernels), plus the
`kytpu::optim.step` span (Adam, the clamp and the copies); from the
program's spans in the traced window."""

from perfbench.metrics import _spans


def read(run, part):
    got = _spans.window(run, part)
    if got is None:
        return None
    recs, entries = got
    backward = _spans.outermost(recs, entries, "kytpu::autograd.backward")
    optim = _spans.outermost(recs, entries, "kytpu::optim.step")
    if not backward:
        return None
    total = _spans.device_ms(recs, backward + optim)
    if total is None:
        return None
    for b in backward:
        total -= _spans.device_ms(recs, _spans.outermost(
            recs, entries, _spans.KERNEL, under=b))
    return total / len(entries)
