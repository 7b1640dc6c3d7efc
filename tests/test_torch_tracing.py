"""The port's spans and counters (kytpu_torch/utils/profiling.py): the span
tree of a train step and of a frame on the CPU under torch.profiler, the
same names as the profiler's user annotations, nothing recorded with the
profiler off, the kernels' launches counted at the launch alone, the
store's window, the synchronising operations charged to the innermost
span, and on the card (marked cuda) the spans' device intervals, one
`.item()` counted as one sync and a frame's K1 launches."""

import warnings
from contextlib import nullcontext

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kytpu_torch.core import rng as krng
from kytpu_torch.diff.inverse import make_train_step
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import launch as klaunch
from kytpu_torch.scene import builders
from kytpu_torch.utils import profiling as kprof
import tests.torch_threads  # noqa: F401  (one torch thread a process)

W, H = 16, 10
SCENE = builders.veach_mis(W, H)
# a frame of 2 spp in passes of one sample: two passes
FRAME = dict(spp=2, seed=5, rays_per_pass=W * H, device="cpu")


def _cpu_profile(new_window: bool = True):
    """A CPU profiler; new_window: a span runs unrecorded first, so the
    store starts anew at the window's first span."""
    if new_window:
        with kprof.span("kytpu::unrecorded"):
            pass
    return profile(activities=[ProfilerActivity.CPU])


def _step():
    target = torch.full((H, W, 3), 0.2)
    step, _, _ = make_train_step(SCENE, target, spp=1, max_depth=2,
                                 kernel_sampler="hash", device="cpu")
    return step


def _tree(recs):
    """[(name, parent's name)] in the order the spans opened."""
    return [(r.name, None if r.parent is None else recs[r.parent].name)
            for r in recs]


def _span_above(event):
    """The name of the innermost `kytpu::` event enclosing a profiler
    event, or None."""
    e = event.cpu_parent
    while e is not None and not e.name.startswith("kytpu::"):
        e = e.cpu_parent
    return None if e is None else e.name


def test_train_step_span_tree():
    step = _step()
    step(krng.key(1))
    with _cpu_profile():
        step(krng.key(2))
    recs = kprof.spans()
    assert _tree(recs) == [
        ("kytpu::train.step", None),
        ("kytpu::rays", "kytpu::train.step"),
        ("kytpu::tables.colors", "kytpu::train.step"),
        ("kytpu::kernel.k2", "kytpu::train.step"),
        ("kytpu::autograd.backward", "kytpu::train.step"),
        ("kytpu::kernel.k3", "kytpu::autograd.backward"),
        ("kytpu::optim.step", "kytpu::train.step")]
    for r in recs:
        assert r.call == 0 and r.device_ms is None and r.syncs == 0
        if r.parent is not None:
            up = recs[r.parent]
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
    assert recs[0].host_ms > 0


def test_frame_span_tree():
    with _cpu_profile():
        render(SCENE, **FRAME)
    recs = kprof.spans()
    one_pass = [("kytpu::pass", "kytpu::render.frame"),
                ("kytpu::rays", "kytpu::pass"),
                ("kytpu::tables.colors", "kytpu::pass"),
                ("kytpu::kernel.k1", "kytpu::pass")]
    assert _tree(recs) == [("kytpu::render.frame", None),
                           ("kytpu::tables.pack", "kytpu::render.frame")
                           ] + one_pass + one_pass
    assert {r.call for r in recs} == {0}


def test_spans_are_the_profilers_user_annotations():
    step = _step()
    with _cpu_profile() as prof:
        step(krng.key(3))
        render(SCENE, **FRAME)
    recs = kprof.spans()
    got = [e for e in prof.events() if e.is_user_annotation
           and e.name.startswith("kytpu::")]
    assert sorted(e.name for e in got) == sorted(r.name for r in recs)
    # the profiler nests them as the records do (backward's spans included:
    # on the CPU autograd runs on the calling thread)
    assert {(e.name, _span_above(e)) for e in got} == set(_tree(recs))
    # two calls in one window: two entry spans, each its own call
    entries = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in entries] == ["kytpu::train.step",
                                               "kytpu::render.frame"]
    assert [r.call for r in recs] == [
        entries[0] if i < entries[1] else entries[1]
        for i in range(len(recs))]


def test_nothing_recorded_with_the_profiler_off(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered while the profiler was off")

    step = _step()
    with _cpu_profile():
        step(krng.key(4))
    before = kprof.spans()
    monkeypatch.setattr(kprof, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    step(krng.key(5))
    render(SCENE, **FRAME)
    with kprof.RenderTimer().phase("optimize"):
        pass
    assert kprof.spans() == before and before


class _Stream:
    cuda_stream = 0


def test_launches_counted_where_launched(monkeypatch):
    """A plain version on the CPU launches nothing; `launch.run`, the card's
    one launch site (its CUDA context stood in for), counts a launch that
    returned no error, in its span `kytpu::launch.<k>`, and none that
    failed; `reset` clears the named kernels' counts."""
    before = dict(kprof.counters)
    render(SCENE, **FRAME)
    _step()(krng.key(6))
    assert kprof.counters == before
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream)
    kprof.reset()
    with _cpu_profile():
        with kprof.kernel("k1"):
            klaunch.run(lambda *a: 0, "wavefront_fwd", "k1", "cpu", 1, 2)
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            klaunch.run(lambda *a: 700, "wavefront_bwd_res", "k3", "cpu")
        klaunch.run(lambda *a: 0, "tag_sort", "tag_sort", "cpu")
    assert _tree(kprof.spans()) == [
        ("kytpu::kernel.k1", None),
        ("kytpu::launch.k1", "kytpu::kernel.k1"),
        ("kytpu::launch.k3", None), ("kytpu::launch.tag_sort", None)]
    assert [kprof.launches(k) for k in ("k1", "k3", "tag_sort")] == [1, 0, 1]
    kprof.reset("k1")
    assert [kprof.launches(k) for k in ("k1", "k3", "tag_sort")] == [0, 0, 1]
    kprof.reset()
    assert kprof.launches("tag_sort") == 0


def test_store_cleared_by_a_new_profiled_window():
    step = _step()
    with _cpu_profile():
        step(krng.key(7))
    with _cpu_profile(new_window=False):
        step(krng.key(8))
    # back to back (a retaken window): both calls kept
    names = [r.name for r in kprof.spans()]
    assert names.count("kytpu::train.step") == 2
    step(krng.key(9))
    assert [r.name for r in kprof.spans()] == names
    with _cpu_profile():
        step(krng.key(10))
    names = [r.name for r in kprof.spans()]
    assert names.count("kytpu::train.step") == 1 and len(names) == 7


def test_timer_phase_is_a_span():
    timer = kprof.RenderTimer()
    with _cpu_profile():
        with timer.phase("optimize", rays=4):
            render(SCENE, **FRAME)
    recs = kprof.spans()
    assert recs[0].name == "kytpu::cli.optimize" and recs[0].parent is None
    assert recs[1].name == "kytpu::render.frame" and recs[1].parent == 0
    assert timer.rays == 4 and list(timer.phases) == ["optimize"]


class _Event:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass


def test_syncs_charged_to_the_innermost_span(monkeypatch):
    """The outermost span's hook, with CUDA stood in for: torch's warning
    for a synchronising operation counts on the innermost open span, other
    warnings pass through, and the sync debug mode is restored."""
    mode = [0]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, m))
    msg = "called a synchronizing CUDA operation (Triggered internally)"
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with _cpu_profile():
            with kprof.span("kytpu::a"):
                assert mode[0] == "warn"
                warnings.warn(msg)
                with kprof.span("kytpu::b"):
                    for _ in range(3):
                        warnings.warn(msg)
                    warnings.warn("other")
        warnings.warn(msg)
    assert mode[0] == 0
    a, b = kprof.spans()
    assert (a.syncs, b.syncs) == (1, 3)
    shown = [str(w.message) for w in seen]
    assert "other" in shown and shown.count(msg) == 1


@pytest.mark.cuda
def test_device_intervals_and_one_item_one_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with kprof.span("kytpu::unrecorded"):
        pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with kprof.span("kytpu::outer"):
            y = x
            with kprof.span("kytpu::work"):
                for _ in range(50):
                    y = torch.sin(y)
            with kprof.span("kytpu::read"):
                y.sum().item()
    assert torch.cuda.get_sync_debug_mode() == mode
    outer, work, read = kprof.spans()
    assert (outer.syncs, work.syncs, read.syncs) == (0, 0, 1)
    assert work.device_ms > 0 and outer.device_ms >= work.device_ms


@pytest.mark.cuda
def test_frame_launches_on_the_card():
    """A frame of two passes on the card launches K1 twice, each launch
    counted and timed in its span inside its dispatch wrapper's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frame = dict(FRAME, device="cuda")
    render(SCENE, **frame)
    before = kprof.launches("k1")
    with kprof.span("kytpu::unrecorded"):
        pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        render(SCENE, **frame)
    assert kprof.launches("k1") == before + 2
    recs = kprof.spans()
    launches = [r for r in recs if r.name == "kytpu::launch.k1"]
    assert len(launches) == 2
    for r in launches:
        up = recs[r.parent]
        assert up.name == "kytpu::kernel.k1"
        assert 0 < r.device_ms <= up.device_ms
