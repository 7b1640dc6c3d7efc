"""A frame's tables kept for the next (kernels/route.py `frame`) on the CPU:
a scene rendered again packs nothing and gives the bits of a render with
an empty cache; any change to a keyed value (in place, through `.data`, or
in a new Scene) packs anew, a change to a colour table does not; another
KernelConfig or a wrapped tracer constructor packs; the big-scene route
reuses too; every tensor of a Scene, its Geometry, Lights and Textures is
keyed unless read per call; the cache keeps FRAME_CACHE tracers, the least recently used evicted, and
threads that share it each get their own frame's bits."""

import copy
import dataclasses
import sys
import threading

import pytest
import torch

from kytpu_torch.bsdf import bsdf as kbsdf
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import route as kroute
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.light.lights import Lights
from kytpu_torch.scene import builders
from kytpu_torch.scene.scene import Scene
from kytpu_torch.scene.shapes import Geometry
from kytpu_torch.scene.texture import Textures
from kytpu_torch.utils import profiling as kprof
import tests.torch_threads  # noqa: F401  (one torch thread a process)

CFG = kwf.KernelConfig(max_depth=2)


def cornell():
    """Rect, sphere, point and environment lights, a glossy floor."""
    return builders.cornell_box(
        builders.DEFAULT_SCENE | {builders.LIGHT_POINT,
                                  builders.LIGHT_ENVIRONMENT},
        width=12, height=12)


def checker():
    """The Cornell box with a checkered floor (row 3 bound to texture 0)."""
    return builders.cornell_box(builders.DEFAULT_SCENE, width=12, height=12,
                                floor_checker=True)


@pytest.fixture(autouse=True)
def frames(monkeypatch):
    """An empty cache for each test, the module's own left as it was."""
    monkeypatch.setattr(kroute, "_frames", [])


def counts():
    """(frames packed, frames that reused a tracer) so far."""
    return (kprof.counters.get("tables.frame.packed", 0),
            kprof.counters.get("tables.frame.reused", 0))


def frame(scene, seed=5, cfg=CFG, **kw):
    return render(scene, spp=2, seed=seed, cfg=cfg, rays_per_pass=1 << 10,
                  device="cpu", **kw)


def cold(scene, seed=5, cfg=CFG, **kw):
    """A frame rendered with an empty cache, the cache and the counters
    left as they were."""
    kept, tally = kroute._frames[:], dict(kprof.counters)
    kroute._frames.clear()
    try:
        return frame(scene, seed, cfg, **kw)
    finally:
        kroute._frames[:] = kept
        kprof.counters.clear()
        kprof.counters.update(tally)


@pytest.mark.parametrize("sampler", ["random", "hash", "sobol"])
def test_second_frame_reuses_the_tables(sampler):
    sc = cornell()
    cfg = dataclasses.replace(CFG, sampler=sampler)
    c0 = counts()
    frame(sc, 5, cfg)
    again = frame(sc, 6, cfg)
    assert counts() == (c0[0] + 1, c0[1] + 1)
    assert torch.equal(again, cold(sc, 6, cfg))


def _point(sc):
    return sc.lights.kinds.index(builders.klights.POINT)


# keyed values changed: in place, through .data, or in a new Scene
KEYED_CHANGES = {
    "sphere_centre": (cornell, lambda sc: sc.geometry.sp_center[0].add_(
        torch.tensor([0.05, 0.0, 0.02]))),
    "planar_vertex_data": (cornell, lambda sc: sc.geometry.pl_p0.data[
        4].add_(0.01)),
    "mat_kind": (cornell, lambda sc: sc.mat_kind.__setitem__(
        1, kbsdf.MAT_MIRROR)),
    "mat_exponent": (cornell, lambda sc: sc.mat_exponent.__setitem__(
        3, 20.0)),
    "light_position": (cornell, lambda sc: sc.lights.position[
        _point(sc)].add_(torch.tensor([0.1, -0.1, 0.0]))),
    "tex_id": (checker, lambda sc: sc.tex_id.__setitem__(1, 0)),
    "new_scene": (cornell, lambda sc: dataclasses.replace(
        sc, lights=dataclasses.replace(
            sc.lights, position=sc.lights.position + torch.tensor(
                [0.0, 0.0, 0.3])))),
}


@pytest.mark.parametrize("name", sorted(KEYED_CHANGES))
def test_keyed_change_packs_anew(name):
    make, change = KEYED_CHANGES[name]
    sc = make()
    before = frame(sc)
    c0 = counts()
    with torch.no_grad():
        new = change(sc)
    sc = new if isinstance(new, Scene) else sc
    got = frame(sc)
    assert counts() == (c0[0] + 1, c0[1])
    assert torch.equal(got, cold(sc))
    assert not torch.equal(got, before)


def test_equal_scene_in_new_tensors_reuses():
    sc = cornell()
    frame(sc)
    c0 = counts()
    twin = copy.deepcopy(sc)
    assert twin.mat_kind.data_ptr() != sc.mat_kind.data_ptr()
    got = frame(twin, 7)
    assert counts() == (c0[0], c0[1] + 1)
    assert torch.equal(got, cold(twin, 7))



def test_fields_of_stride_zero_key_by_value():
    """smallpt has no planar rows (its empty geometry tables have stride
    0); a field held as an expanded view keys by its values alone."""
    sc = builders.smallpt(12, 8)
    assert sc.geometry.pl_kind.numel() == 0
    c0 = counts()
    frame(sc)
    assert counts() == (c0[0] + 1, c0[1])
    twin = dataclasses.replace(sc, tex_id=torch.tensor(
        [-1], dtype=torch.int32).expand(sc.tex_id.shape[0]))
    assert torch.equal(twin.tex_id, sc.tex_id)
    got = frame(twin, 6)
    assert counts() == (c0[0] + 1, c0[1] + 1)
    assert torch.equal(got, cold(sc, 6))


COLOR_CHANGES = {
    "mat_diffuse": lambda sc: sc.mat_diffuse[0].mul_(0.5),
    "emission": lambda sc: sc.emission[
        int(sc.lights.surface_ids[0])].mul_(2.0),
    "env_radiance": lambda sc: sc.env_radiance_.mul_(3.0),
}


@pytest.mark.parametrize("name", sorted(COLOR_CHANGES))
def test_color_change_reuses_the_tables(name):
    sc = cornell()
    before = frame(sc)
    c0 = counts()
    with torch.no_grad():
        COLOR_CHANGES[name](sc)
    got = frame(sc)
    assert counts() == (c0[0], c0[1] + 1)
    assert torch.equal(got, cold(sc))
    assert not torch.equal(got, before)


@pytest.mark.parametrize("change", [dict(shadow="robust"),
                                    dict(max_depth=3), dict(nee="single")])
def test_another_config_packs_anew(change):
    sc = cornell()
    frame(sc)
    c0 = counts()
    cfg = dataclasses.replace(CFG, **change)
    got = frame(sc, cfg=cfg)
    assert counts() == (c0[0] + 1, c0[1])
    assert torch.equal(got, cold(sc, cfg=cfg))
    frame(sc, cfg=cfg)
    assert counts() == (c0[0] + 1, c0[1] + 1)


def test_another_engine_packs_anew():
    sc = cornell()
    frame(sc)
    c0 = counts()
    got = frame(sc, engine="bigscene")
    assert counts() == (c0[0] + 1, c0[1])
    assert torch.equal(got, cold(sc, engine="bigscene"))


def test_big_scene_reuses_its_tables():
    """The sphereflake at size factor 2 (92 surfaces): the table route."""
    sc = builders.spd_balls(2, 8, 6)
    assert int(sc.mat_kind.shape[0]) > kroute.TABLE_ROUTE_SURFACES
    cfg = kwf.KernelConfig(max_depth=2, sampler="hash")
    c0 = counts()
    frame(sc, 5, cfg)
    again = frame(sc, 6, cfg)
    assert counts() == (c0[0] + 1, c0[1] + 1)
    assert torch.equal(again, cold(sc, 6, cfg))
    with torch.no_grad():
        sc.geometry.sp_radius[5].mul_(0.5)
    got = frame(sc, 6, cfg)
    assert counts() == (c0[0] + 2, c0[1] + 1)
    assert torch.equal(got, cold(sc, 6, cfg))


def textured():
    """A scene whose every field is a non-empty tensor where it can be: the
    checkered box with rect, sphere, point and environment lights and an
    image on the back wall."""
    return builders.cornell_box(
        builders.DEFAULT_SCENE | {builders.LIGHT_POINT,
                                  builders.LIGHT_ENVIRONMENT},
        width=12, height=12, floor_checker=True,
        back_image=torch.rand(4, 4, 3,
                              generator=torch.Generator().manual_seed(3)))


@pytest.mark.parametrize("cls", [Scene, Geometry, Lights, Textures],
                         ids=lambda c: c.__name__)
def test_every_tensor_keyed_but_the_per_call_ones(cls):
    """Each tensor field of a Scene, its Geometry, Lights and Textures
    changes the key's bytes, unless UNKEYED lists it: then the key is
    unchanged. A field added later is keyed unless it is listed."""
    sc = textured()
    part = {Scene: None, Geometry: "geometry", Lights: "lights",
            Textures: "textures"}[cls]
    obj = sc if part is None else getattr(sc, part)
    meta, data = kroute._scene_key(sc)
    seen = set()
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if not isinstance(v, torch.Tensor) or v.numel() == 0:
            continue
        new = dataclasses.replace(obj, **{f.name: v + 1})
        twin = (new if part is None
                else dataclasses.replace(sc, **{part: new}))
        meta2, data2 = kroute._scene_key(twin)
        assert meta2 == meta, f.name
        assert (data2 == data) == (f.name in kroute.UNKEYED.get(cls, ())), (
            f.name)
        seen.add(f.name)
    tensors = {f.name for f in dataclasses.fields(cls)
               if isinstance(getattr(obj, f.name), torch.Tensor)}
    assert seen == tensors


def test_wrapped_constructor_neither_reuses_nor_stays():
    """A frame under a wrapped tracer constructor packs with it though an
    equal key was kept, and the next frame under the module's own
    constructor is not served the wrapper's tracer."""
    sc = cornell()
    sound = frame(sc)
    real = kwf.make_cuda_tracer

    def doubled(scene, cfg=None):
        fn = real(scene, cfg)
        return lambda *a, **kw: fn(*a, **kw) * 2.0

    c0 = counts()
    kwf.make_cuda_tracer = doubled
    try:
        planted = frame(sc)
        assert counts() == (c0[0] + 1, c0[1])
        assert torch.equal(planted, cold(sc))
    finally:
        kwf.make_cuda_tracer = real
    assert not torch.equal(planted, sound)
    again = frame(sc)
    assert counts() == (c0[0] + 1, c0[1] + 1)
    assert torch.equal(again, sound)


def test_cache_evicts_the_least_recently_used():
    sc = cornell()
    cfgs = [dataclasses.replace(CFG, max_depth=d)
            for d in range(1, kroute.FRAME_CACHE + 2)]
    for cfg in cfgs[:-1]:
        frame(sc, cfg=cfg)
    frame(sc, cfg=cfgs[0])          # now the most recently used
    c0 = counts()
    frame(sc, cfg=cfgs[-1])         # evicts cfgs[1]
    assert len(kroute._frames) == kroute.FRAME_CACHE
    frame(sc, cfg=cfgs[0])
    assert counts() == (c0[0] + 1, c0[1] + 1)
    frame(sc, cfg=cfgs[1])
    assert counts() == (c0[0] + 2, c0[1] + 1)
    assert len(kroute._frames) == kroute.FRAME_CACHE


def test_threads_share_the_cache():
    """Four threads render one scene under five configs in turn, more
    keys than the cache keeps, with a short switch interval: every frame
    has the bits of its config's frame rendered alone."""
    sc = cornell()
    cfgs = [dataclasses.replace(CFG, max_depth=d) for d in range(1, 6)]
    want = [cold(sc, cfg=cfg) for cfg in cfgs]
    wrong = []

    def work(t):
        for j in range(4):
            k = (t + j) % len(cfgs)
            if not torch.equal(frame(sc, cfg=cfgs[k]), want[k]):
                wrong.append((t, j))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert wrong == []
    assert len(kroute._frames) <= kroute.FRAME_CACHE
