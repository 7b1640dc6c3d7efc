"""Observability: wall-clock phase timing, rays/s counters, device traces
(kytpu/utils/profiling.py).

`RenderTimer` accumulates per-phase wall time and ray counts (the
reference's `timing_seconds` and per-row progress printf, ky.cpp:156-163,
3703); `trace_to` wraps a block in a torch.profiler trace, written as a
Chrome trace (chrome://tracing, Perfetto) into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class RenderTimer:
    """Per-phase seconds and rays. A phase's clock stops after a
    torch.cuda.synchronize() where CUDA is initialized, so its seconds hold
    the device work it queued; kytpu's timer, on JAX's asynchronous
    dispatch, counts the device work only where the caller blocks on it."""

    phases: dict = field(default_factory=dict)   # name -> seconds
    rays: int = 0

    @contextlib.contextmanager
    def phase(self, name: str, rays: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.rays += rays

    @property
    def total(self) -> float:
        return sum(self.phases.values())

    def rays_per_second(self) -> float:
        t = self.total
        return self.rays / t if t > 0 else 0.0

    def report(self) -> str:
        lines = [f"{k:>16s}: {v:8.3f} s" for k, v in self.phases.items()]
        lines.append(f"{'total':>16s}: {self.total:8.3f} s"
                     f"  ({self.rays_per_second()/1e6:.2f} Mrays/s)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Trace the enclosed block with torch.profiler (the CPU, and the card
    where torch sees one) and write it into logdir as a Chrome trace,
    trace_<pid>_<ns>.json. Yields the profiler (its key_averages())."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
