"""Observability: spans and counters at the port's layer boundaries,
wall-clock phase timing, rays/s counters, device traces
(kytpu/utils/profiling.py).

`span(name)` marks a layer boundary (`kytpu::<layer>`). It records only
while torch.profiler records (`trace_to`, or any `torch.profiler.profile`);
otherwise it costs one flag check. A recorded span keeps its name, its
parent, its call (the outermost span it runs under), its host interval,
the device interval of a pair of CUDA events on the current stream
(resolved when read), the synchronising CUDA operations run directly under
it (counted by the outermost span, through torch's sync debug mode, a
prototype that may miss some), and opens
`torch.profiler.record_function(name)`, so the profiler's trace shows it
over the device's operations. `spans()` returns the records of
the current or last profiled window: the store is cleared at the first
outermost span recorded after a span that ran unrecorded.

`counters` holds `kernel.<k>.launches` (k1 ... k8, tag_sort,
segment_sums, rays), always on: `launched(k)` adds one where a kernel was
launched on the card and returned no error (a CPU plain version launches
nothing), `launches(k)` reads it and `reset(*kernels)` sets it to 0. The
launch itself runs in the span `kytpu::launch.<k>`, nested in the span
`kytpu::kernel.<k>` of the dispatch wrapper that chose it (`kernel(k)`),
so the launch span's device interval is the kernel's alone and the
wrapper's also holds the host's preparation of its arguments; the camera
rays' launch nests directly in `kytpu::rays`.

`kernel.<k>.rows`, `kernel.<k>.sweeps` and `kernel.<k>.bounds` (k5, k6,
k8: the table kernels' sweeps, csrc/bigscene_fwd.cu: the rows each lane's
warp tested for it, the lane-sweeps, and the node steps each lane's warp
took in its tree walks) are counted on the card, and only while
torch.profiler records: `row_counter(k, device)` gives a launch the
device buffer to add to (None otherwise), and `device_counts()` reads the
buffers once, after the window. They hold the current or last profiled
window, as `spans()` does, and `reset` clears them with the launches.

`RenderTimer` accumulates per-phase wall time and ray counts (the
reference's `timing_seconds` and per-row progress printf, ky.cpp:156-163,
3703), each phase a span `kytpu::cli.<phase>`; `trace_to` wraps a block in
a torch.profiler trace, written as a Chrome trace (chrome://tracing,
Perfetto) into a directory.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
import warnings
from dataclasses import dataclass, field

import torch

# true while torch.profiler records (on this thread, and on the autograd
# threads of a backward started from it)
_recording = torch._C._autograd._profiler_enabled
record_function = torch.profiler.record_function
_OFF = contextlib.nullcontext()
# torch's message for each synchronising CUDA operation under sync debug
# mode "warn"
_SYNC = "called a synchronizing CUDA operation"

counters: dict = {}
# kernel -> int64 (3,) on the card: the rows its warps' leaf phases tested
# (summed over the lanes in each sweep), the lane-sweeps, and the node steps
# of its warps' walks (summed likewise), while recording
_swept: dict = {}


def count(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n


def launched(kernel: str) -> None:
    """Count one launch of `kernel` on the card."""
    count(f"kernel.{kernel}.launches")


def launches(kernel: str) -> int:
    """`kernel.<kernel>.launches` (k1 ... k8, tag_sort, segment_sums,
    rays)."""
    return counters.get(f"kernel.{kernel}.launches", 0)


def reset(*kernels: str) -> None:
    """Set the launch counts and the rows swept of `kernels` (of every
    kernel where none is named) to 0."""
    for name in list(counters):
        if name.startswith("kernel.") and name.endswith(".launches") and (
                not kernels or name.split(".")[1] in kernels):
            del counters[name]
    for k in list(_swept):
        if not kernels or k in kernels:
            del _swept[k]


def row_counter(kernel: str, device) -> torch.Tensor | None:
    """The int64 (3,) buffer on `device` that a launch of `kernel` (k5,
    k6, k8) adds its rows swept, lane-sweeps and node steps to, while
    torch.profiler records; else None, and the launch counts nothing."""
    if not _recording():
        return None
    buf = _swept.get(kernel)
    if buf is None or buf.device != torch.device(device):
        buf = _swept[kernel] = torch.zeros(3, dtype=torch.int64,
                                           device=device)
    return buf


def device_counts() -> dict:
    """`kernel.<k>.rows`, `.sweeps` and `.bounds` of the current or last
    profiled window, read from the card (a sync each: call it after the
    window, never inside a call)."""
    out = {}
    for k, buf in _swept.items():
        rows, sweeps, bounds = buf.tolist()
        out[f"kernel.{k}.rows"] = rows
        out[f"kernel.{k}.sweeps"] = sweeps
        out[f"kernel.{k}.bounds"] = bounds
    return out


@dataclass
class SpanRecord:
    name: str
    parent: int | None    # index in spans() of the enclosing span
    call: int             # index in spans() of the outermost one
    start_ns: int         # host, time.perf_counter_ns()
    end_ns: int = 0
    syncs: int = 0        # synchronising CUDA operations directly under it
    events: tuple | None = field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> float | None:
        """Milliseconds between the span's two CUDA events on its stream
        (waits for the second); None where CUDA was not initialized."""
        if self.events is None:
            return None
        begin, end = self.events
        end.synchronize()
        return begin.elapsed_time(end)


_store: list = []     # SpanRecord of the current or last profiled window
_open: list = []      # indices in _store of the open spans, innermost last
_stale = False        # a span ran unrecorded since the store was written


def spans() -> list:
    """The span records of the current or last profiled window."""
    return list(_store)


def _count_sync(message, category, filename, lineno, file=None, line=None,
                shown=None):
    if str(message).startswith(_SYNC):
        if _open:
            _store[_open[-1]].syncs += 1
    else:
        shown(message, category, filename, lineno, file, line)


class _Span:
    __slots__ = ("name", "rf", "sync", "mode")

    def __init__(self, name: str):
        self.name = name
        self.sync = None

    def __enter__(self):
        global _stale
        outer = not _open
        if outer and _stale:
            _store.clear()
            _swept.clear()
            _stale = False
        i = len(_store)
        rec = SpanRecord(self.name, None if outer else _open[-1],
                         i if outer else _open[0], time.perf_counter_ns())
        _store.append(rec)
        _open.append(i)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            if outer:
                self.sync = warnings.catch_warnings()
                self.sync.__enter__()
                warnings.filterwarnings("always", message=_SYNC)
                warnings.showwarning = functools.partial(
                    _count_sync, shown=warnings.showwarning)
                self.mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        return rec

    def __exit__(self, *exc):
        rec = _store[_open[-1]]
        if rec.events is not None:
            rec.events[1].record()
        if self.sync is not None:
            torch.cuda.set_sync_debug_mode(self.mode)
            self.sync.__exit__(None, None, None)
        self.rf.__exit__(*exc)
        rec.end_ns = time.perf_counter_ns()
        _open.pop()
        return False


def span(name: str):
    """A context manager marking the layer boundary `name`: recorded (see
    the module's docstring) only while torch.profiler records."""
    global _stale
    if _recording():
        return _Span(name)
    if not _open:
        _stale = True
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner
    return wrap


def kernel(k: str):
    """The span `kytpu::kernel.<k>` of a kernel's dispatch wrapper (the
    plain version's run on the CPU too)."""
    return span(f"kytpu::kernel.{k}")


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
            with span(f"kytpu::cli.{name}"):
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
