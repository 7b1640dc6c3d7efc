"""SPD's sphereflake (kytpu_torch/scene/builders.py `spd_balls`, Haines
1987) and its benchmark cell spd_balls.table_train4 on the CPU: the flake's
counts and tangencies, the floor, the lights, the table route that the
train step takes past 64 surfaces, the port's step against the benchmark's
plain reference (perfbench/reference/tables.py) within the cell's limits,
the planted faults that the cell's check catches (perfbench/faults_table.py),
and the reference's own builder (perfbench/reference/frozen/scene/spd.py)
against the port's, table for table."""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kytpu_torch.diff import inverse
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import route as kroute
from kytpu_torch.light import lights as klights
from kytpu_torch.scene import builders
from perfbench import faults_table, harness
from perfbench.reference.frozen.scene import spd
import tests.torch_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]
CELL = "spd_balls.table_train4"
# the cell cut to a size a CPU holds: factor 2 (92 surfaces, past 64),
# 32x20, 2 spp, depth 3
SMALL = {"args": {"size_factor": 2, "width": 32, "height": 20},
         "traffic": {"spp": 2, "max_depth": 3, "target_spp": 1,
                     "trace_seconds": 0.1}}
LIMITS = json.loads((ROOT / "perfbench/limits" / f"{CELL}.json").read_text())


@pytest.mark.parametrize("factor, n", [(1, 10), (2, 91), (3, 820)])
def test_flake_counts_and_tangency(factor, n):
    c, r, parent = builders.sphereflake(factor)
    assert len(r) == n and parent[0] == -1
    scene = builders.spd_balls(factor, 16, 16)
    assert int(scene.mat_kind.shape[0]) == n + 1
    g = scene.geometry
    c32 = g.sp_center.double().numpy()
    r32 = g.sp_radius.double().numpy()
    np.testing.assert_array_equal(c32, c.astype(np.float32))
    kid = np.arange(1, n)
    gap = np.linalg.norm(c32[kid] - c32[parent[kid]], axis=-1) - (
        r32[kid] + r32[parent[kid]])
    assert np.abs(gap).max() <= 1e-6
    np.testing.assert_allclose(r[kid], r[parent[kid]] / 3.0, rtol=1e-15)
    # no sphere inside or through another: every pair at least tangent
    d = np.linalg.norm(c32[:, None] - c32[None], axis=-1) - (
        r32[:, None] + r32[None])
    np.fill_diagonal(d, np.inf)
    assert d.min() >= -1e-6


def test_floor_lights_and_camera():
    scene = builders.spd_balls(1, 32, 20)
    g = scene.geometry
    assert g.n_planar == 1
    floor = torch.stack([g.pl_p0[0], g.pl_p1[0], g.pl_p2[0], g.pl_p3[0]])
    assert torch.all(floor[:, 2] == -0.5)
    assert torch.equal(floor[:, :2].abs(), torch.full((4, 2), 12.0))
    # the root touches the floor
    assert float(g.sp_center[0, 2] - g.sp_radius[0]) == -0.5
    assert scene.lights.kinds == (klights.POINT,) * 3 + (klights.ENV,)
    np.testing.assert_array_equal(scene.lights.position[:3].numpy(),
                                  np.float32(builders.SPD_LIGHTS))
    assert scene.has_env
    np.testing.assert_array_equal(scene.env_radiance_.numpy(),
                                  np.float32(builders.SPD_SKY))
    assert (scene.camera.width, scene.camera.height) == (32, 20)
    np.testing.assert_array_equal(scene.camera.position.numpy(),
                                  np.float32([2.1, 1.3, 1.7]))


def test_the_step_takes_the_table_kernels(monkeypatch):
    scene = builders.spd_balls(2, 16, 12)
    assert kroute.tables_of(scene) is not None
    made = []
    real = kbs.make_bigscene_diff_tracer

    def spy(*a, **kw):
        made.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(kbs, "make_bigscene_diff_tracer", spy)
    step, params, _ = inverse.make_train_step(
        scene, torch.full((12, 16, 3), 0.3), spp=1, max_depth=2,
        names=("mat_diffuse", "mat_specular", "env_radiance_"), device="cpu")
    assert made == [1]
    loss = float(step(inverse.krng.key(3)))
    assert np.isfinite(loss)
    assert params["mat_diffuse"].shape == (92, 3)


def _run(plant=None):
    with faults_table.planted(plant) if plant else contextlib.nullcontext():
        res, compared, _ = harness.run_cell(
            ROOT, CELL, 2**33 + 29, 0.05, False, time.perf_counter(),
            device="cpu", sizes=SMALL)
    return res, {k: c["value"] for k, c in compared.items()}


def test_the_step_against_the_reference():
    """Three of the port's steps (the plain K6 and K7 on CPU tensors)
    against the reference's: every number within the cell's limits."""
    res, numbers = _run()
    assert res["correct"] and set(numbers) == set(LIMITS)
    assert all(numbers[k] <= LIMITS[k] for k in LIMITS), numbers
    assert numbers["loss_gap"] == 0.0


@pytest.mark.parametrize("plant", faults_table.PLANTS)
def test_a_planted_fault_is_caught(plant):
    res, numbers = _run(plant)
    assert not res["correct"], numbers


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_the_reference_builds_the_same_tables(factor):
    got = builders.spd_balls(factor, 24, 16)
    ref = spd.spd_balls(factor, 24, 16)
    for name in ("mat_kind", "mat_diffuse", "mat_specular", "mat_exponent",
                 "mat_eta", "mat_d_prob", "mat_s_prob", "emission",
                 "light_index", "world_center", "world_radius",
                 "env_radiance_", "tex_id"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for part in ("geometry", "camera", "lights"):
        a, b = getattr(got, part), getattr(ref, part)
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            assert same, (part, f)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.tables, "
            "perfbench.counts.tables; print(sorted({m.split('.')[0] for m "
            "in sys.modules} & {'jax', 'jaxlib', 'flax', 'kytpu', "
            "'kytpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


class _Rec:
    def __init__(self, name, parent, device_ms):
        self.name, self.parent, self.device_ms = name, parent, device_ms
        self.host_ms, self.syncs = 0.0, 0


def _traced_run(monkeypatch, work):
    """Two synthetic table train steps: K6's launch 20 ms, K7's 1 ms, the
    tag sort's 0.25 ms and the segment sums' 0.25 ms a step."""
    from kytpu_torch.utils import profiling

    recs = []
    for _ in range(2):
        p = len(recs)
        recs += [_Rec("kytpu::train.step", None, 30.0),
                 _Rec("kytpu::kernel.k6", p, 20.5),
                 _Rec("kytpu::launch.k6", p + 1, 20.0),
                 _Rec("kytpu::autograd.backward", p, 2.0),
                 _Rec("kytpu::kernel.k7", p + 3, 1.8),
                 _Rec("kytpu::launch.k7", p + 4, 1.0),
                 _Rec("kytpu::kernel.tag_sort", p + 4, 0.3),
                 _Rec("kytpu::launch.tag_sort", p + 6, 0.25),
                 _Rec("kytpu::kernel.segment_sums", p + 4, 0.3),
                 _Rec("kytpu::launch.segment_sums", p + 8, 0.25)]
    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    monkeypatch.setattr(profiling, "device_counts", lambda: {
        "kernel.k6.rows": 9000, "kernel.k6.sweeps": 12,
        "kernel.k6.bounds": 3000})
    run = harness.Run(entry="train", lanes=1, setup_s=0.0)
    run.profile = object()
    run.work = work
    return run


def test_the_cells_readers(monkeypatch):
    from perfbench.metrics.transport_roofline import PEAKS

    work = {"fwd_ops": 67e9, "fwd_bytes": 3.35e8, "bwd_bytes": 3.35e8}
    run = _traced_run(monkeypatch, work)
    read = {n: harness.reader(f"{n}.train")[0] for n in (
        "table_fwd_roofline", "table_bwd_roofline", "rows_swept",
        "bounds_swept")}
    # K6's least: 1 ms of operations against 0.1 ms of bytes, over 20 ms
    assert read["table_fwd_roofline"](run, "train") == pytest.approx(5.0)
    # K7's least: 0.1 ms of bytes over 1 + 0.25 + 0.25 ms
    assert read["table_bwd_roofline"](run, "train") == pytest.approx(
        100 * 0.1 / 1.5)
    assert read["rows_swept"](run, "train") == 750.0
    assert read["bounds_swept"](run, "train") == 250.0
    run.profile = None
    assert all(r(run, "train") is None for r in read.values())
    assert PEAKS["fp32_flop_s"] == 67e12


def test_the_least_work_counts():
    """One lane that hits a row at bounce 0 with one shadow ray lit and
    goes on to miss at bounce 1, at depth 2."""
    from perfbench.counts import tables as counts
    from perfbench.reference import oracle
    from perfbench.reference import tables as ref

    config = {"scene": "spd_balls",
              "args": {"size_factor": 1, "width": 8, "height": 8},
              "transport": {"nee": "all", "sampler": "random",
                            "shadow": "parity", "rr_start": 3}}
    cfg = oracle.kernel_config(config, {"max_depth": 2})
    static = ref.bs.extract_tables(ref.build_scene(config, "cpu"))[0]
    ix, planes = ref.bs.layout_of(static, cfg)
    resf, resi = torch.zeros(planes, 1), torch.zeros(3, 1, dtype=torch.int32)
    resf[ix[("B", 0, 1)]] = 0.5
    resf[ix[("tu", 0)]] = 0.25
    resi[0] = 4
    t = counts.TableTally()
    t.add(static, cfg, resf, resi)
    assert t.traced == [1, 1, 0] and t.hits == [1, 0, 0] and t.lit == [1, 0]
    shade = 32 + 62 + 6 + 134 * 4 + 90
    assert counts.fwd_ops(static, cfg, t) == 33 * 2 + shade + 19
    assert counts.fwd_bytes(cfg, t) == 24 + 12 + 4 * (planes + 3)
    assert counts.bwd_bytes(static, cfg, t) == (4 * (planes + 3) + 24 + 12
                                                + 4 * 11 * 9)


def test_the_row_counter_counts_only_while_recording():
    """kprof.row_counter gives a launch a buffer only inside a profiled
    window; device_counts reads it, a new window and reset clear it."""
    from torch.profiler import ProfilerActivity, profile

    from kytpu_torch.utils import profiling as kprof

    kprof.reset("k6")
    assert kprof.row_counter("k6", "cpu") is None
    with profile(activities=[ProfilerActivity.CPU]):
        with kprof.span("kytpu::train.step"):
            buf = kprof.row_counter("k6", "cpu")
            buf += torch.tensor([40, 5, 30])
            assert kprof.row_counter("k6", "cpu") is buf
    assert kprof.device_counts() == {"kernel.k6.rows": 40,
                                     "kernel.k6.sweeps": 5,
                                     "kernel.k6.bounds": 30}
    with kprof.span("kytpu::train.step"):   # unrecorded: the window is over
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with kprof.span("kytpu::train.step"):
            assert "kernel.k6.rows" not in kprof.device_counts()
            kprof.row_counter("k6", "cpu")
    kprof.reset("k6")
    assert kprof.device_counts() == {}


def test_the_node_step_reader_without_the_counter(monkeypatch):
    """bounds_swept on a program whose counters have no kernel.k6.bounds
    (a checkout before the tree walk) gives None and does not raise."""
    from kytpu_torch.utils import profiling

    read = harness.reader("bounds_swept.train")[0]
    run = _traced_run(monkeypatch, {})
    monkeypatch.setattr(profiling, "device_counts", lambda: {
        "kernel.k6.rows": 9000, "kernel.k6.sweeps": 12})
    assert read(run, "train") is None
    monkeypatch.setattr(profiling, "device_counts", lambda: {})
    assert read(run, "train") is None
    monkeypatch.delattr(profiling, "device_counts")
    assert read(run, "train") is None
