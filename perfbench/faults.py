"""The control and the faults that `correct` has to catch, planted in the
port for the length of a `with planted(name):` block. The benchmark's own
runs never plant anything; readings.py and the tests do.

- "control": the configuration's float32 one step lower, where a later
  change would be tempted to take it: every lane's radiance and every
  table gradient of the kernels (the port's trace_lanes and bwd_res)
  rounded to bfloat16, as the reference computed in bfloat16 and put in
  the port's place would give them;
- "half": half of the batch left out, the mean taken over the rest (a
  train step's second half of samples a copy of its first; a frame of
  half the spp);
- "unchanged": a call that returns its state unchanged (Adam's step does
  nothing; a frame call returns the first frame it rendered);
- "altered": an answer altered where it is produced (the cache
  backward's diffuse gradient times 1.5; every pass's radiance times
  1 + 2**-10).
"""

from __future__ import annotations

import contextlib
import torch

PLANTS = ("control", "half", "unchanged", "altered")


@contextlib.contextmanager
def planted(name: str):
    from kytpu_torch.kernels import wavefront as kwf

    if name not in PLANTS:
        raise ValueError(f"unknown plant {name!r}: one of {PLANTS}")
    saved = {k: getattr(kwf, k) for k in ("make_cuda_diff_tracer",
                                          "render_cuda", "bwd_res",
                                          "make_cuda_tracer", "trace_lanes")}
    adam_step = torch.optim.Adam.step
    diff, render, bwd, tracer, trace = (
        saved["make_cuda_diff_tracer"], saved["render_cuda"],
        saved["bwd_res"], saved["make_cuda_tracer"], saved["trace_lanes"])
    first = []

    if name == "control":
        def low(x):
            return x.to(torch.bfloat16).to(torch.float32)

        def trace_b(*a, **kw):
            out = trace(*a, **kw)
            return ((low(out[0]),) + tuple(out[1:]) if isinstance(out, tuple)
                    else low(out))

        def bwd_b(*a, **kw):
            return tuple(low(g) for g in bwd(*a, **kw))

        kwf.trace_lanes, kwf.bwd_res = trace_b, bwd_b
    elif name == "half":
        def make_diff(scene, cfg=None, backward="residual"):
            fn = diff(scene, cfg, backward)

            def halved(*a):
                out = fn(*a)
                n = out.shape[0] // 2
                return torch.cat([out[:n], out[:n]])

            halved.tabs = fn.tabs
            return halved

        def render_h(scene, spp=16, *a, **kw):
            return render(scene, max(1, spp // 2), *a, **kw)

        kwf.make_cuda_diff_tracer, kwf.render_cuda = make_diff, render_h
    elif name == "unchanged":
        def render_u(*a, **kw):
            if not first:
                first.append(render(*a, **kw))
            return first[0].clone()

        torch.optim.Adam.step = lambda self, closure=None: None
        kwf.render_cuda = render_u
    else:
        def bwd_a(*a, **kw):
            out = list(bwd(*a, **kw))
            out[0] = out[0] * 1.5
            return tuple(out)

        def make_tracer(scene, cfg=None):
            fn = tracer(scene, cfg)
            return lambda *a, **kw: fn(*a, **kw) * (1.0 + 2.0 ** -10)

        kwf.bwd_res, kwf.make_cuda_tracer = bwd_a, make_tracer
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(kwf, k, v)
        torch.optim.Adam.step = adam_step
