"""The device profile of a traced window: busy time, kernels, idle gaps.

The busy union and the warm-up kernels are copies of chip_smoke.py's
`device_profile` and `profiler_warm` (commit 35fb5ad). The profiler kept
no record of a window's first kernels late in a long process, so every
window starts with WARM kernels, then one MARK kernel, and a window whose
profile lacks the MARK kernel is taken again: its first kernel of the
program's own may be missing too.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

# the warm-up and marker kernels, dropped from every profile: no measured
# path runs digamma or lgamma
WARM_NAME = "digamma"
MARK_NAME = "lgamma"
TOP = 10
NAME_CHARS = 120   # a device kernel's name, cut: templates run to thousands


def profiler_warm() -> None:
    """Small kernels, waited for, at the start of a profiled window: the
    trace kept no record of a window's first kernels, so those are these,
    16 of them; then the marker whose record shows that recording had
    begun."""
    x = torch.zeros(1, device="cuda")
    for _ in range(16):
        x.digamma_()
    x.lgamma_()
    torch.cuda.synchronize()


@dataclass
class Profile:
    window_s: float          # host seconds from the first call to the last result
    busy_s: float            # union of the device kernels' intervals
    kernels: int             # device operations in the window
    calls: int               # calls of the entry point in the window
    device_ops: list = field(default_factory=list)   # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)    # [[host op, seconds]]


def _union(intervals) -> tuple[float, list]:
    """(busy microseconds, the merged intervals) of sorted (start, end)."""
    busy, merged = 0.0, []
    for s, t in intervals:
        if merged and s <= merged[-1][1]:
            if t > merged[-1][1]:
                busy += t - merged[-1][1]
                merged[-1][1] = t
        else:
            busy += t - s
            merged.append([s, t])
    return busy, merged


def _host_op_at(cpu, starts, t: float, reach: int = 200) -> str:
    """The innermost host op running at time t: of the `reach` ops that
    started last before t, the latest started that still runs; "python"
    where none does."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(cpu[max(0, i - reach):i]):
        if e.time_range.end >= t:
            return e.name
    return "python"


def profile_calls(run_call, n_calls: int, tries: int = 2) -> Profile:
    """Profile n_calls of run_call(k) -> None (each waits for its result on
    the host). Retaken once where the MARK kernel is missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiler_warm()
            t0 = time.perf_counter()
            for k in range(n_calls):
                run_call(k)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        if any(MARK_NAME in e.name for e in dev):
            break
    else:
        raise RuntimeError("the profile kept no record of the window's "
                           "marker kernel")
    # the device's operations after the marker: kernels, copies and
    # memsets; the ranges that record_function spans (the optimizer's)
    # leave on the device's timeline are not operations
    mark_end = max(e.time_range.end for e in dev if MARK_NAME in e.name)
    dev = sorted((e for e in dev if e.time_range.start >= mark_end
                  and not getattr(e, "is_user_annotation", False)
                  and WARM_NAME not in e.name and MARK_NAME not in e.name),
                 key=lambda e: e.time_range.start)
    if not dev:
        raise RuntimeError("the profile shows no device kernel in the window")
    busy_us, merged = _union((e.time_range.start, e.time_range.end)
                             for e in dev)
    by_name: dict = {}
    for e in dev:
        name = e.name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in cpu]
    idle: dict = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        name = _host_op_at(cpu, starts, 0.5 * (a + b))
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Profile(window_s=window_s, busy_s=busy_us * 1e-6,
                   kernels=len(dev), calls=n_calls,
                   device_ops=[[n, s] for n, s in ops],
                   idle_gaps=[[n, s] for n, s in gaps])
