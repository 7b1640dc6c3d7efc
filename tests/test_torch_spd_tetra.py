"""SPD's tetrahedral pyramid (kytpu_torch/scene/builders.py `spd_tetra`,
Haines 1987, after Glassner 1984) and its benchmark cell
spd_tetra.tri_train4 on the CPU: the pyramid's triangle counts, area,
bounds and winding, the reference's own builder
(perfbench/reference/frozen/scene/tetra.py) against the port's, table for
table, the table route that the train step takes past 64 surfaces, the
port's step against the benchmark's plain reference
(perfbench/reference/tetra.py) within the cell's limits with the planted
faults of perfbench/faults_table.py caught, the cell's least-work count
(perfbench/counts/tri.py) and its three readers."""

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
from perfbench.reference.frozen.scene import tetra
import tests.torch_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]
CELL = "spd_tetra.tri_train4"
# the cell cut to a size a CPU holds: factor 3 (65 surfaces, past 64),
# 32x20, 2 spp, depth 3
SMALL = {"args": {"size_factor": 3, "width": 32, "height": 20},
         "traffic": {"spp": 2, "max_depth": 3, "target_spp": 1,
                     "trace_seconds": 0.1}}
LIMITS = json.loads((ROOT / "perfbench/limits" / f"{CELL}.json").read_text())
# the root tetrahedron of edge 2: its vertices, and its surface area
ROOT_V = np.array([[1.0, -1.0 / np.sqrt(3.0), 0.0],
                   [-1.0, -1.0 / np.sqrt(3.0), 0.0],
                   [0.0, 2.0 / np.sqrt(3.0), 0.0],
                   [0.0, 0.0, 2.0 * np.sqrt(2.0 / 3.0)]])
ROOT_AREA = 4.0 * np.sqrt(3.0)


def _normals(t):
    return np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])


@pytest.mark.parametrize("factor", [1, 2, 3, 4])
def test_pyramid_counts_area_bounds_and_winding(factor):
    t = builders.sierpinski(factor)
    assert t.shape == (4 ** factor, 3, 3)
    assert int(builders.spd_tetra(factor, 8, 8).mat_kind.shape[0]) == \
        4 ** factor + 1
    # the faces of the half-size corners cover the root's surface area
    area = 0.5 * np.linalg.norm(_normals(t), axis=-1)
    assert area.sum() == pytest.approx(ROOT_AREA, rel=1e-12)
    np.testing.assert_allclose(area, ROOT_AREA / 4 ** factor, rtol=1e-12)
    # every vertex inside the root: barycentric coordinates in [0, 1]
    m = np.stack([ROOT_V[j] - ROOT_V[3] for j in range(3)], 1)
    lam = np.linalg.solve(m, (t.reshape(-1, 3) - ROOT_V[3]).T).T
    lam = np.concatenate([lam, 1.0 - lam.sum(1, keepdims=True)], 1)
    assert lam.min() >= -1e-12 and lam.max() <= 1.0 + 1e-12
    # outward: each face's normal points away from its leaf's fourth vertex
    leaves = t.reshape(-1, 4, 3, 3)
    centre = leaves.reshape(-1, 12, 3).mean(1)
    for i in range(4):
        f = leaves[:, i]
        out = np.einsum("nk,nk->n", _normals(f), f.mean(1) - centre)
        assert (out > 0).all()


def test_floor_lights_and_camera():
    scene = builders.spd_tetra(1, 32, 20)
    g = scene.geometry
    assert g.n_planar == 5
    floor = torch.stack([g.pl_p0[0], g.pl_p1[0], g.pl_p2[0], g.pl_p3[0]])
    assert torch.all(floor[:, 2] == -0.25)
    assert torch.equal(floor[:, :2].abs(), torch.full((4, 2), 12.0))
    assert scene.lights.kinds == (klights.POINT, klights.ENV)
    np.testing.assert_array_equal(scene.lights.position[0].numpy(),
                                  np.float32([4.0, -3.0, 6.0]))
    np.testing.assert_array_equal(scene.lights.emit[0].numpy(),
                                  np.float32([60.0] * 3))
    np.testing.assert_array_equal(scene.env_radiance_.numpy(),
                                  np.float32(builders.SPD_SKY))
    np.testing.assert_array_equal(scene.mat_diffuse[1:].numpy(),
                                  np.float32(0.8))
    np.testing.assert_array_equal(scene.camera.position.numpy(),
                                  np.float32([2.4, -3.0, 2.0]))


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_the_reference_builds_the_same_tables(factor):
    np.testing.assert_array_equal(tetra.triangles(factor),
                                  builders.sierpinski(factor))
    got = builders.spd_tetra(factor, 24, 16)
    ref = tetra.spd_tetra(factor, 24, 16)
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


def test_the_step_takes_the_table_kernels(monkeypatch):
    """65 surfaces at factor 3: past 64, so the family rule gives the
    scene to K5-K8 and the train step builds the big-scene tracer."""
    scene = builders.spd_tetra(3, 16, 12)
    assert int(scene.mat_kind.shape[0]) == 65
    assert kroute.tables_of(scene) is not None
    made = []
    real = kbs.make_bigscene_diff_tracer

    def spy(*a, **kw):
        made.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(kbs, "make_bigscene_diff_tracer", spy)
    step, params, _ = inverse.make_train_step(
        scene, torch.full((12, 16, 3), 0.3), spp=1, max_depth=2,
        names=("mat_diffuse", "env_radiance_"), device="cpu")
    assert made == [1]
    assert np.isfinite(float(step(inverse.krng.key(3))))
    assert params["mat_diffuse"].shape == (65, 3)


@pytest.mark.parametrize("plant", (None,) + faults_table.PLANTS)
def test_the_step_against_the_reference(plant):
    """Three of the port's steps (the plain K6 and K7 on CPU tensors)
    against the reference's: every number within the cell's limits, and
    each planted fault caught."""
    with faults_table.planted(plant) if plant else contextlib.nullcontext():
        res, compared, _ = harness.run_cell(
            ROOT, CELL, 2**33 + 31, 0.05, False, time.perf_counter(),
            device="cpu", sizes=SMALL)
    numbers = {k: c["value"] for k, c in compared.items()}
    assert set(numbers) == set(LIMITS)
    if plant is None:
        assert res["correct"], numbers
        assert all(numbers[k] <= LIMITS[k] for k in LIMITS), numbers
        assert numbers["loss_gap"] == 0.0
    else:
        assert not res["correct"], numbers


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.tetra, "
            "perfbench.counts.tri; print(sorted({m.split('.')[0] for m "
            "in sys.modules} & {'jax', 'jaxlib', 'flax', 'kytpu', "
            "'kytpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_least_work_counts():
    """One lane that hits a triangle at bounce 0 with one shadow ray lit
    and goes on to miss at bounce 1, at depth 2: a triangle's row test at
    each traced bounce, the Lambertian shading with two lights, one
    shadow ray's row test."""
    from perfbench.counts import tri
    from perfbench.reference import oracle
    from perfbench.reference import tetra as ref

    config = {"scene": "spd_tetra",
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
    t = tri.TableTally()
    t.add(static, cfg, resf, resi)
    assert t.traced == [1, 1, 0] and t.hits == [1, 0, 0] and t.lit == [1, 0]
    shade = 20 + 44 + 6 + 36 * 2 + 9 + 62
    assert tri.fwd_ops(static, cfg, t) == 39 * 2 + shade + 27
    assert tri.fwd_bytes(cfg, t) == 24 + 12 + 4 * (planes + 3)


class _Rec:
    def __init__(self, name, parent, device_ms):
        self.name, self.parent, self.device_ms = name, parent, device_ms
        self.host_ms, self.syncs = 0.0, 0


@pytest.mark.parametrize("counted", ["all", "no_split", "none", "no_api"])
def test_the_cells_readers(monkeypatch, counted):
    """tri_fwd_roofline over two synthetic steps (K6's launch 20 ms a
    step), tri_rows_swept and tri_bounds_swept from the counters' tri
    class; None without a traced window, and the two counter readers None
    on a program without the class split, without counts, or without
    `device_counts`, without raising."""
    from kytpu_torch.utils import profiling

    recs = []
    for _ in range(2):
        p = len(recs)
        recs += [_Rec("kytpu::train.step", None, 30.0),
                 _Rec("kytpu::kernel.k6", p, 20.5),
                 _Rec("kytpu::launch.k6", p + 1, 20.0)]
    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    totals = {"kernel.k6.rows": 9000, "kernel.k6.sweeps": 12,
              "kernel.k6.bounds": 3000}
    split = {"kernel.k6.rows.tri": 6000, "kernel.k6.bounds.tri": 2400}
    if counted == "no_api":
        monkeypatch.delattr(profiling, "device_counts")
    else:
        got = {"all": {**totals, **split}, "no_split": totals,
               "none": {}}[counted]
        monkeypatch.setattr(profiling, "device_counts", lambda: dict(got))
    run = harness.Run(entry="train", lanes=1, setup_s=0.0)
    run.profile = object()
    run.work = {"fwd_ops": 67e9, "fwd_bytes": 3.35e8, "bwd_bytes": 3.35e8}
    read = {n: harness.reader(f"{n}.train")[0] for n in (
        "tri_fwd_roofline", "tri_rows_swept", "tri_bounds_swept")}
    # K6's least: 1 ms of operations against 0.1 ms of bytes, over 20 ms
    assert read["tri_fwd_roofline"](run, "train") == pytest.approx(5.0)
    rows = read["tri_rows_swept"](run, "train")
    bounds = read["tri_bounds_swept"](run, "train")
    if counted == "all":
        assert (rows, bounds) == (500.0, 200.0)
    else:
        assert rows is None and bounds is None
    run.profile = None
    assert all(r(run, "train") is None for r in read.values())
