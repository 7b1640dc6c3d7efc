"""The readers of the program's spans (metrics/tables_ms.py, rays_ms.py,
autograd_ms.py, kernel_roofline.py, host_syncs.py): per call on synthetic
records, None where the program has no spans (an older checkout) or the
run no traced window, and on the records of a CPU step and frame, where
only the host's tables_ms has a value."""

from dataclasses import dataclass

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness
from perfbench.metrics.transport_roofline import PEAKS

READERS = ("tables_ms", "rays_ms", "autograd_ms", "kernel_roofline",
           "host_syncs")


@dataclass
class Rec:
    name: str
    parent: int | None
    host_ms: float
    device_ms: float | None
    syncs: int = 0


def _step_recs(base: int) -> list:
    """One train step: jitter 20 ms on the device, the colour tables 19 ms
    on the host (waiting for it), K2's wrapper 13 ms holding its launch's
    12 ms, backward 4 ms holding K3's wrapper 3 ms (its launch 1.5 ms, and
    the segment sums' wrapper 1 ms holding their launch's 0.5 ms), Adam
    0.5 ms; 1 + 1 + 2 syncs."""
    p = base
    return [Rec("kytpu::train.step", None, 45.0, 40.0, 1),
            Rec("kytpu::rays", p, 1.0, 20.0, 1),
            Rec("kytpu::tables.colors", p, 19.0, 0.1, 2),
            Rec("kytpu::kernel.k2", p, 0.1, 13.0),
            Rec("kytpu::launch.k2", p + 3, 0.1, 12.0),
            Rec("kytpu::autograd.backward", p, 0.3, 4.0),
            Rec("kytpu::kernel.k3", p + 5, 0.1, 3.0),
            Rec("kytpu::launch.k3", p + 6, 0.1, 1.5),
            Rec("kytpu::kernel.segment_sums", p + 6, 0.1, 1.0),
            Rec("kytpu::launch.segment_sums", p + 8, 0.1, 0.5),
            Rec("kytpu::optim.step", p, 0.2, 0.5)]


def _run(entry, monkeypatch, recs, work=None):
    from kytpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    run = harness.Run(entry=entry, lanes=1, setup_s=0.0)
    run.profile = object()
    run.work = work
    return run


def _read(name, run, part):
    read, _ = harness.reader(f"{name}.{part}")
    return read(run, part)


def test_per_call_on_synthetic_train_records(monkeypatch):
    # a stray table pack outside any step counts for nothing
    recs = ([Rec("kytpu::tables.pack", None, 7.0, 7.0, 5)]
            + _step_recs(1) + _step_recs(12))
    least_s = 1.4e-3
    work = {"fp32_ops": least_s * PEAKS["fp32_flop_s"], "bytes": 1}
    run = _run("train", monkeypatch, recs, work)
    assert _read("tables_ms", run, "train") == pytest.approx(19.0)
    assert _read("rays_ms", run, "train") == pytest.approx(20.0)
    assert _read("autograd_ms", run, "train") == pytest.approx(1.5)
    # the launches alone, not their wrappers' argument packing: 14 ms
    assert _read("kernel_roofline", run, "train") == pytest.approx(10.0)
    assert _read("host_syncs", run, "train") == pytest.approx(4.0)


def test_per_call_on_synthetic_frame_records(monkeypatch):
    recs = [Rec("kytpu::render.frame", None, 90.0, 80.0, 3),
            Rec("kytpu::tables.pack", 0, 5.0, 5.0, 9)]
    for _ in range(2):
        p = len(recs)
        recs += [Rec("kytpu::pass", 0, 40.0, 37.0),
                 Rec("kytpu::rays", p, 1.0, 10.0, 1),
                 Rec("kytpu::tables.colors", p, 0.2, 0.01),
                 Rec("kytpu::kernel.k1", p, 0.1, 9.0),
                 Rec("kytpu::launch.k1", p + 3, 0.1, 8.0)]
    run = _run("frame", monkeypatch, recs,
               {"fp32_ops": 0, "bytes": 0.8e-3 * PEAKS["hbm_bytes_s"]})
    assert _read("tables_ms", run, "frame") == pytest.approx(5.4)
    assert _read("rays_ms", run, "frame") == pytest.approx(20.0)
    assert _read("kernel_roofline", run, "frame") == pytest.approx(5.0)
    assert _read("host_syncs", run, "frame") == pytest.approx(14.0)
    # no backward in a frame, and the train entry's spans are not there
    assert harness.reader("autograd_ms.train")[0](run, "frame") is None
    assert _read("rays_ms", run, "train") is None


def test_none_without_spans_or_a_traced_window(monkeypatch):
    from kytpu_torch.utils import profiling

    run = _run("train", monkeypatch, _step_recs(0),
               {"fp32_ops": 1.0, "bytes": 1})
    monkeypatch.delattr(profiling, "spans")
    for name in READERS:
        assert _read(name, run, "train") is None
    monkeypatch.undo()
    run = _run("train", monkeypatch, _step_recs(0),
               {"fp32_ops": 1.0, "bytes": 1})
    run.profile = None
    for name in READERS:
        assert _read(name, run, "train") is None
    run = _run("train", monkeypatch, [], {"fp32_ops": 1.0, "bytes": 1})
    for name in READERS:
        assert _read(name, run, "train") is None


def test_records_of_a_cpu_step_and_frame():
    """The program's own records on the CPU: the tables' host time, and no
    device interval, so no device reading and no sync count."""
    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff.inverse import make_train_step
    from kytpu_torch.integrator.render import render
    from kytpu_torch.scene import builders

    sc = builders.veach_mis(16, 10)
    step, _, _ = make_train_step(sc, torch.full((10, 16, 3), 0.2), spp=1,
                                 max_depth=2, kernel_sampler="hash",
                                 device="cpu")
    work = {"fp32_ops": 1e6, "bytes": 1e3}
    for entry, call in (
            ("train", lambda k: step(krng.key(k))),
            ("frame", lambda k: render(sc, spp=1, seed=k, device="cpu"))):
        call(0)
        with profile(activities=[ProfilerActivity.CPU]):
            for k in (1, 2):
                call(k)
        run = harness.Run(entry=entry, lanes=1, setup_s=0.0)
        run.profile, run.work = object(), work
        assert _read("tables_ms", run, entry) > 0
        for name in READERS[1:]:
            assert _read(name, run, entry) is None
