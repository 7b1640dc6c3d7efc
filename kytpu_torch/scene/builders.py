"""Scene factories: Cornell box, Veach MIS, smallpt, random spheres and
triangle meshes (kytpu/scene/builders.py).

Parity targets: create_cornell_box_scene (ky.cpp:3240-3432) and
create_mis_scene (ky.cpp:3434-3533); `smallpt` is kytpu's smallpt scene;
`random_spheres` and `mesh_scene` are kytpu's scene-scale scenes (hundreds
to thousands of surfaces), which run on the big-scene kernels
(kernels/bigscene.py). Geometry is assembled on the host in
numpy and every table is float32, built with the same float32 arithmetic as
the JAX package's builders, so both packages produce bit-identical scenes.

As in the JAX package, `veach_mis` binds each sphere light to its own
sphere by default; `replicate_reference_swap=True` reproduces the
reference's crossed bindings of lights 1 and 2.
"""

from __future__ import annotations

import numpy as np
import torch

from kytpu_torch import bsdf as kbsdf
from kytpu_torch.core import math as km
from kytpu_torch.light import lights as klights
from kytpu_torch.scene import scene as kscene
from kytpu_torch.scene import shapes as kshapes
from kytpu_torch.scene import texture as ktex

# cornell_box_enum_t flags (ky.cpp:3121-3145)
LIGHT_AREA = "light_area"
LIGHT_DIRECTION = "light_direction"
LIGHT_POINT = "light_point"
LIGHT_ENVIRONMENT = "light_environment"
LARGE_MIRROR_SPHERE = "large_mirror_sphere"
LARGE_GLASS_SPHERE = "large_glass_sphere"
SMALL_MIRROR_SPHERE = "small_mirror_sphere"
SMALL_GLASS_SPHERE = "small_glass_sphere"
BOTH_SMALL_SPHERES = frozenset({SMALL_MIRROR_SPHERE, SMALL_GLASS_SPHERE})
DEFAULT_SCENE = BOTH_SMALL_SPHERES | {LIGHT_AREA}


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.tensor(np.asarray(v, np.float64), dtype=torch.float32)


def _full(v) -> torch.Tensor:
    return torch.full((3,), v, dtype=torch.float32)


class _SceneAssembler:
    """Collects surfaces, materials and lights, then freezes a Scene."""

    def __init__(self):
        self.geo = kshapes.GeometryBuilder()
        self._mats = []
        self._emission = []
        self._light_of_surface = []
        self._lights = []
        self._textures = []   # dicts for scene/texture.build

    def add_checker(self, color_a, color_b, scale=(1.0, 1.0)) -> int:
        """A procedural checkerboard; returns the texture slot to pass as
        `texture=` to a material. Its colours are trainable leaves."""
        self._textures.append(dict(kind=ktex.CHECKER, color_a=color_a,
                                   color_b=color_b, scale=scale))
        return len(self._textures) - 1

    def add_image_texture(self, image, scale=(1.0, 1.0)) -> int:
        """An (H, W, 3) image texture, wrap-addressed bilinear; its texels
        are trainable leaves. All images of a scene share a resolution."""
        self._textures.append(dict(kind=ktex.IMAGE, image=image,
                                   scale=scale))
        return len(self._textures) - 1

    @staticmethod
    def matte(color, texture: int = -1):
        return dict(kind=kbsdf.MAT_MATTE, diffuse=color, specular=_full(0.0),
                    exponent=0.0, eta=1.0, texture=texture)

    @staticmethod
    def mirror(color):
        return dict(kind=kbsdf.MAT_MIRROR, diffuse=_full(0.0), specular=color,
                    exponent=0.0, eta=1.0)

    @staticmethod
    def glass(eta, reflection=None, transmission=None):
        return dict(kind=kbsdf.MAT_GLASS,
                    diffuse=_full(1.0) if transmission is None else transmission,
                    specular=_full(1.0) if reflection is None else reflection,
                    exponent=0.0, eta=eta)

    @staticmethod
    def plastic(diffuse, specular, shininess, texture: int = -1):
        return dict(kind=kbsdf.MAT_PLASTIC, diffuse=diffuse,
                    specular=specular, exponent=shininess, eta=1.0,
                    texture=texture)

    def surface(self, shape_handle: int, material: dict, emission=None,
                light_slot: int | None = None):
        self._mats.append(material)
        self._emission.append(_full(0.0) if emission is None else emission)
        self._light_of_surface.append(-1 if light_slot is None else light_slot)
        return shape_handle

    def add_light(self, **kw) -> int:
        self._lights.append(kw)
        return len(self._lights) - 1

    def build(self, camera: kscene.Camera) -> kscene.Scene:
        geometry, surf_ids = self.geo.build()
        n_surf = geometry.n_surfaces
        order = np.argsort(surf_ids)   # assembler order -> row order
        assert sorted(surf_ids) == list(range(n_surf)), \
            "every shape must be bound to exactly one surface"

        def row(i):
            return self._mats[order[i]]

        mat_kind = torch.tensor([row(i)["kind"] for i in range(n_surf)],
                                dtype=torch.int32)
        mat_diffuse = torch.stack([_f32(row(i)["diffuse"])
                                   for i in range(n_surf)])
        mat_specular = torch.stack([_f32(row(i)["specular"])
                                    for i in range(n_surf)])
        mat_exponent = torch.from_numpy(np.array(
            [row(i)["exponent"] for i in range(n_surf)], np.float32))
        mat_eta = torch.from_numpy(np.array(
            [row(i)["eta"] for i in range(n_surf)], np.float32))

        # plastic lobe probabilities from luminance (ky.cpp:2653-2658)
        dl = km.luminance(mat_diffuse)
        sl = km.luminance(mat_specular)
        tot = torch.clamp_min(dl + sl, 1e-12)
        is_plastic = mat_kind == kbsdf.MAT_PLASTIC
        mat_d_prob = torch.where(is_plastic, dl / tot, torch.ones_like(dl))
        mat_s_prob = torch.where(is_plastic, sl / tot, torch.zeros_like(sl))

        emission = torch.stack([_f32(self._emission[order[i]])
                                for i in range(n_surf)])
        light_index = torch.tensor(
            [self._light_of_surface[order[i]] for i in range(n_surf)],
            dtype=torch.int32)
        center, radius = self.geo.bounding_sphere()
        env = [lt for lt in self._lights if lt["kind"] == klights.ENV]
        # texture binding (the plastic lobe probabilities stay those of the
        # base diffuse, as kytpu's)
        tex_id = torch.tensor([row(i).get("texture", -1)
                               for i in range(n_surf)], dtype=torch.int32)
        return kscene.Scene(
            camera=camera, geometry=geometry, mat_kind=mat_kind,
            mat_diffuse=mat_diffuse, mat_specular=mat_specular,
            mat_exponent=mat_exponent, mat_eta=mat_eta,
            mat_d_prob=mat_d_prob, mat_s_prob=mat_s_prob, emission=emission,
            light_index=light_index, lights=self._freeze_lights(surf_ids),
            world_center=_f32(center), world_radius=_f32(radius),
            has_env=bool(env),
            env_radiance_=_f32(env[0]["emit"]) if env else _full(0.0),
            has_textures=bool(self._textures), tex_id=tex_id,
            textures=ktex.build(self._textures))

    def _freeze_lights(self, surf_ids) -> klights.Lights:
        z3 = np.zeros(3, np.float32)
        cols = {k: [] for k in ("emit", "position", "direction", "p0", "p1",
                                "p2", "p3", "normal", "center")}
        area, radius, kinds, sids = [], [], [], []
        for lt in self._lights:
            kinds.append(lt["kind"])
            handle = lt.get("surface_handle")
            sids.append(-1 if handle is None else surf_ids[handle])
            for k in cols:
                v = lt.get(k)
                cols[k].append(_f32(z3 if v is None else v))
            area.append(lt.get("area") or 0.0)
            radius.append(lt.get("radius") or 0.0)

        def st(xs):
            return torch.stack(xs) if xs else torch.zeros((0, 3))

        return klights.Lights(
            kinds=tuple(kinds), surface_ids=tuple(sids),
            **{k: st(v) for k, v in cols.items()},
            area=torch.from_numpy(np.array(area, np.float32)),
            radius=torch.from_numpy(np.array(radius, np.float32)))


def _rect_light_params(pts, flip=False):
    """Canonical rect shape params for an area light (p0..p3, normal, area)."""
    q0, q1, q2, q3 = [np.asarray(p, np.float64) for p in pts]
    n = np.cross(q1 - q0, q2 - q0)
    n = n / np.linalg.norm(n)
    if flip:
        n = -n
    area = float(np.linalg.norm(np.cross(q0 - q1, q2 - q1)))
    return dict(p0=q0, p1=q1, p2=q2, p3=q3, normal=n, area=area)


def cornell_box(flags=DEFAULT_SCENE, width: int = 256, height: int = 256,
                overrides: dict | None = None, floor_checker: bool = False,
                back_image=None) -> kscene.Scene:
    """The Cornell box (ky.cpp:3240-3432). `flags` is a set of the LIGHT_*
    and *_SPHERE strings above; `overrides` maps 'white', 'red', 'green',
    'blue', 'glossy_diffuse', 'glossy_specular', 'light_radiance',
    'env_radiance', 'point_intensity' or 'dir_irradiance' to a colour (and
    'checker_a', 'checker_b' with floor_checker). floor_checker swaps the
    glossy floor for a checkered matte; back_image pastes an (H, W, 3)
    image texture on the back wall (the texture-recovery target)."""
    flags = frozenset(flags)
    ov = overrides or {}
    if LARGE_MIRROR_SPHERE in flags and LARGE_GLASS_SPHERE in flags:
        raise ValueError("cannot set both large balls")

    cam = kscene.make_camera(
        position=(-0.0439815, 4.12529, 0.222539),
        front=(0.00688625, -0.998505, -0.0542161),
        up=(3.73896e-4, -0.0542148, 0.998529),
        fov_degrees=80.0, width=width, height=height)

    a = _SceneAssembler()
    m_black = a.matte(_full(0.0))
    m_white = a.matte(ov.get("white", _full(0.8)))
    m_red = a.matte(ov.get("red", _f32([0.803922, 0.152941, 0.152941])))
    m_green = a.matte(ov.get("green", _f32([0.156863, 0.803922, 0.172549])))
    m_blue = a.matte(ov.get("blue", _f32([0.156863, 0.172549, 0.803922])))
    m_glossy = a.plastic(ov.get("glossy_diffuse", _full(0.1)),
                         ov.get("glossy_specular", _full(0.7)), 90.0)
    m_mirror = a.mirror(_full(1.0))
    m_glass = a.glass(1.6)
    if floor_checker:
        checker = a.add_checker(ov.get("checker_a", _full(0.73)),
                                ov.get("checker_b", _full(0.18)),
                                scale=(6.0, 6.0))
        m_glossy = a.matte(_full(0.73), texture=checker)
    if back_image is not None:
        tex = a.add_image_texture(back_image)
        m_blue = a.matte(_full(0.5), texture=tex)

    cb = np.array([
        [-1.27029, -1.30455, -1.28002],
        [1.28975, -1.30455, -1.28002],
        [1.28975, -1.30455, 1.28002],
        [-1.27029, -1.30455, 1.28002],
        [-1.27029, 1.25549, -1.28002],
        [1.28975, 1.25549, -1.28002],
        [1.28975, 1.25549, 1.28002],
        [-1.27029, 1.25549, 1.28002],
    ])
    g = a.geo
    a.surface(g.add_rectangle(cb[3], cb[0], cb[4], cb[7]), m_green)   # left
    a.surface(g.add_rectangle(cb[1], cb[2], cb[6], cb[5]), m_red)     # right
    a.surface(g.add_rectangle(cb[2], cb[3], cb[7], cb[6]), m_white)   # top
    a.surface(g.add_rectangle(cb[0], cb[1], cb[5], cb[4]), m_glossy)  # bottom
    a.surface(g.add_rectangle(cb[0], cb[3], cb[2], cb[1]), m_blue)    # back

    large_radius = 0.8
    large_center = ((cb[0] + cb[4] + cb[5] + cb[1]) / 4.0
                    + np.array([0, 0, large_radius]))
    small_radius = 0.5
    left_wall_center = (cb[0] + cb[4]) / 2.0 + np.array([0, 0, small_radius])
    right_wall_center = (cb[1] + cb[5]) / 2.0 + np.array([0, 0, small_radius])
    length_x = right_wall_center[0] - left_wall_center[0]
    left_center = left_wall_center + np.array([2.0 * length_x / 7.0, 0, 0])
    right_center = right_wall_center - np.array([2.0 * length_x / 7.0, 0, 0])

    if LARGE_MIRROR_SPHERE in flags:
        a.surface(g.add_sphere(large_center, large_radius), m_mirror)
    elif LARGE_GLASS_SPHERE in flags:
        a.surface(g.add_sphere(large_center, large_radius), m_glass)
    if SMALL_MIRROR_SPHERE in flags:
        a.surface(g.add_sphere(left_center, small_radius), m_mirror)
    if SMALL_GLASS_SPHERE in flags:
        a.surface(g.add_sphere(right_center, small_radius), m_glass)

    if LIGHT_AREA in flags:
        lb = np.array([
            [-0.25, -0.25, 1.26002],
            [0.25, -0.25, 1.26002],
            [0.25, -0.25, 1.28002],
            [-0.25, -0.25, 1.28002],
            [-0.25, 0.25, 1.26002],
            [0.25, 0.25, 1.26002],
            [0.25, 0.25, 1.28002],
            [-0.25, 0.25, 1.28002],
        ])
        a.surface(g.add_rectangle(lb[3], lb[7], lb[4], lb[0]), m_white)
        a.surface(g.add_rectangle(lb[1], lb[5], lb[6], lb[2]), m_white)
        a.surface(g.add_rectangle(lb[4], lb[7], lb[6], lb[5]), m_white)
        a.surface(g.add_rectangle(lb[0], lb[1], lb[2], lb[3]), m_white)
        radiance = ov.get("light_radiance", _full(25.0))
        bottom2_pts = (lb[0], lb[4], lb[5], lb[1])
        slot = a.add_light(kind=klights.AREA_RECT, emit=radiance,
                           **_rect_light_params(bottom2_pts))
        a._lights[slot]["surface_handle"] = a.surface(
            g.add_rectangle(*bottom2_pts), m_black, emission=radiance,
            light_slot=slot)

    if LIGHT_DIRECTION in flags:
        a.add_light(kind=klights.DIRECTION,
                    emit=ov.get("dir_irradiance", _f32([10.0, 4.0, 0.0])),
                    direction=np.array([-1.0, -1.5, -1.0])
                    / np.linalg.norm([-1.0, -1.5, -1.0]))

    if LIGHT_POINT in flags:
        a.add_light(kind=klights.POINT,
                    emit=ov.get("point_intensity",
                                _full(70.0 * km.INV_4PI)),
                    position=np.array([0.0, 0.5, 1.0]))

    if LIGHT_ENVIRONMENT in flags:
        env = ov.get("env_radiance",
                     km.div(_f32([135.0, 206.0, 250.0]), 255.0))
        a.add_light(kind=klights.ENV, emit=env)

    return a.build(cam)


def veach_mis(width: int = 512, height: int = 308,
              overrides: dict | None = None,
              replicate_reference_swap: bool = False) -> kscene.Scene:
    """The Veach MIS scene (ky.cpp:3434-3533, mitsuba's veach_mis):
    four glossy plates of rising roughness under five sphere lights."""
    ov = overrides or {}
    cam = kscene.make_camera(
        position=(0.0, 2.0, -15.0), front=(0.0, -4.0, 12.5),
        up=(0.0, 1.0, 0.0), fov_degrees=50.0, width=width, height=height)

    a = _SceneAssembler()
    m_black = a.matte(_full(0.0))
    m_gray = a.matte(ov.get("gray", _full(0.4)))
    m_silver = a.plastic(ov.get("silver_diffuse", _f32([0.07, 0.09, 0.13])),
                         ov.get("silver_specular", _full(1.0)), 5000.0)
    g = a.geo

    a.surface(g.add_rectangle((-10, -4.14615, 10), (-10, -4.14615, -10),
                              (10, -4.14615, -10), (10, -4.14615, 10),
                              flip_normal=True), m_gray)
    a.surface(g.add_rectangle((-10, -10, 2), (-10, 10, 2),
                              (10, 10, 2), (10, -10, 2),
                              flip_normal=True), m_gray)
    planks = [
        ((4, -2.70651, -0.25609), (4, -2.08375, 0.526323),
         (-4, -2.08375, 0.526323), (-4, -2.70651, -0.25609)),
        ((4, -3.28825, -1.36972), (4, -2.83856, -0.476536),
         (-4, -2.83856, -0.476536), (-4, -3.28825, -1.36972)),
        ((4, -3.73096, -2.70046), (4, -3.43378, -1.74564),
         (-4, -3.43378, -1.74564), (-4, -3.73096, -2.70046)),
        ((4, -3.99615, -4.0667), (4, -3.82069, -3.08221),
         (-4, -3.82069, -3.08221), (-4, -3.99615, -4.0667)),
    ]
    for pts in planks:
        a.surface(g.add_rectangle(*pts, flip_normal=True), m_silver)

    balls = [((10.0, 10.0, -4.0), 0.5), ((-3.75, 0.0, 0.0), 0.03333),
             ((-1.25, 0.0, 0.0), 0.1), ((1.25, 0.0, 0.0), 0.3),
             ((3.75, 0.0, 0.0), 0.9)]
    radiances = [800.0, 901.803, 100.0, 11.1111, 1.23457]
    shape_of_light = ([0, 2, 1, 3, 4] if replicate_reference_swap
                      else [0, 1, 2, 3, 4])
    for i, ((c, r), rad) in enumerate(zip(balls, radiances)):
        emit = ov.get(f"light{i}_radiance", _full(rad))
        sc, sr = balls[shape_of_light[i]]
        slot = a.add_light(kind=klights.AREA_SPHERE, emit=emit,
                           center=np.asarray(sc), radius=sr)
        a._lights[slot]["surface_handle"] = a.surface(
            g.add_sphere(c, r), m_black, emission=emit, light_slot=slot)

    return a.build(cam)


def smallpt(width: int = 256, height: int = 256,
            overrides: dict | None = None) -> kscene.Scene:
    """The classic 9-sphere smallpt Cornell box (kytpu's `smallpt`), scaled
    by 1/100 so the fixed geometric epsilons (tuned for unit-scale scenes)
    hold in float32: radius-1,000 wall spheres, which exercise the stable
    sphere quadratic, a mirror and a glass ball, and a sphere light mostly
    buried in the ceiling. The radiance and albedo values are the published
    smallpt constants."""
    ov = overrides or {}
    s = 0.01  # scene scale
    # smallpt advances every ray origin 140 units along its direction, which
    # puts the effective pinhole inside the box: the camera sits there
    front = np.array([0.0, -0.042612, -1.0])
    front = front / np.linalg.norm(front)
    pos = (np.array([50.0, 52.0, 295.6]) + 140.0 * front) * s
    cam = kscene.make_camera(
        position=pos, front=front, up=(0.0, 1.0, 0.0),
        fov_degrees=float(2.0 * np.degrees(np.arctan(0.5135 / 2.0))),
        width=width, height=height)

    a = _SceneAssembler()
    g = a.geo

    def sph(cx, cy, cz, r):
        return g.add_sphere((cx * s, cy * s, cz * s), r * s)

    m = _SceneAssembler
    a.surface(sph(1e5 + 1, 40.8, 81.6, 1e5), m.matte(_f32([0.75, 0.25, 0.25])))
    a.surface(sph(-1e5 + 99, 40.8, 81.6, 1e5),
              m.matte(_f32([0.25, 0.25, 0.75])))
    a.surface(sph(50, 40.8, 1e5, 1e5), m.matte(ov.get("back", _full(0.75))))
    a.surface(sph(50, 40.8, -1e5 + 170, 1e5), m.matte(_full(0.0)))
    a.surface(sph(50, 1e5, 81.6, 1e5), m.matte(_full(0.75)))
    a.surface(sph(50, -1e5 + 81.6, 81.6, 1e5), m.matte(_full(0.75)))
    a.surface(sph(27, 16.5, 47, 16.5), m.mirror(_full(0.999)))
    a.surface(sph(73, 16.5, 78, 16.5), m.glass(1.5, _full(0.999),
                                               _full(0.999)))

    emit = ov.get("light_radiance", _full(12.0))
    c_l = (50 * s, (681.6 - 0.27) * s, 81.6 * s)
    r_l = 600 * s
    slot = a.add_light(kind=klights.AREA_SPHERE, emit=emit,
                       center=np.asarray(c_l), radius=r_l)
    a._lights[slot]["surface_handle"] = a.surface(
        g.add_sphere(c_l, r_l), m.matte(_full(0.0)), emission=emit,
        light_slot=slot)
    return a.build(cam)


def random_spheres(n: int = 100, width: int = 256, height: int = 256,
                   seed: int = 0) -> kscene.Scene:
    """kytpu's scene-scale stress scene: `n` spheres on a ground plane,
    drawn from np.random.default_rng(seed) in kytpu's order, so both
    packages build bit-identical tables. Layout: a ground rectangle that
    grows with n, `n` non-overlapping spheres (70% matte, 15% mirror, 10%
    glass, 5% glossy plastic), one sphere area light overhead and a dim sky
    environment light. (kytpu's `accel=` is the grid accelerator, ROADMAP
    item M11; the port has none.)"""
    rng = np.random.default_rng(seed)
    m = _SceneAssembler
    a = _SceneAssembler()
    g = a.geo

    # the ground grows with n so rejection placement does not saturate
    half = max(12.0, 1.1 * float(np.sqrt(n)))
    a.surface(g.add_rectangle((-half, 0.0, -half), (-half, 0.0, half),
                              (half, 0.0, half), (half, 0.0, -half)),
              m.matte(_full(0.65)))

    # Poisson-ish placement: reject overlaps against accepted spheres
    placed = []
    tries = 0
    while len(placed) < n and tries < 40 * n:
        tries += 1
        r = float(rng.uniform(0.25, 0.7))
        x = float(rng.uniform(-half * 0.85, half * 0.85))
        z = float(rng.uniform(-half * 0.85, half * 0.85))
        if any((x - px) ** 2 + (z - pz) ** 2 < (r + pr + 0.05) ** 2
               for px, pz, pr in placed):
            continue
        placed.append((x, z, r))
    for x, z, r in placed:
        u = float(rng.uniform())
        col = rng.uniform(0.2, 0.95, 3).astype(np.float32)
        if u < 0.70:
            mat = m.matte(torch.from_numpy(col))
        elif u < 0.85:
            mat = m.mirror(_full(0.95))
        elif u < 0.95:
            mat = m.glass(1.5)
        else:
            mat = m.plastic(torch.from_numpy(col * np.float32(0.3)),
                            _full(0.6), float(rng.uniform(30.0, 200.0)))
        a.surface(g.add_sphere((x, r, z), r), mat)

    emit = _full(40.0 * max(1.0, (half / 12.0) ** 2))
    c_l, r_l = (0.0, 1.2 * half, 0.0), 0.2 * half
    slot = a.add_light(kind=klights.AREA_SPHERE, emit=emit,
                       center=np.asarray(c_l), radius=r_l)
    a._lights[slot]["surface_handle"] = a.surface(
        g.add_sphere(c_l, r_l), m.matte(_full(0.0)), emission=emit,
        light_slot=slot)
    a.add_light(kind=klights.ENV, emit=_f32([0.15, 0.18, 0.25]))

    cam = kscene.make_camera(
        position=(0.0, 0.58 * half, 1.83 * half), front=(0.0, -0.28, -1.0),
        up=(0.0, 1.0, 0.0), fov_degrees=55.0, width=width, height=height)
    return a.build(cam)


def mesh_scene(verts, faces, material: dict | None = None,
               width: int = 256, height: int = 256, ground: bool = True,
               light_scale: float = 1.0) -> kscene.Scene:
    """A triangle mesh on a ground plane under a sphere light and a dim sky
    (kytpu's `mesh_scene`). (verts, faces) come from `scene/mesh.py` or any
    (V, 3)/(F, 3) pair with outward CCW winding; each face becomes one
    one-sided triangle surface row, and degenerate (zero-area) faces are
    dropped. `material` is one of the assembler's material dicts (default
    a glossy plastic). The camera frames the mesh bounds."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    if faces.size == 0:
        raise ValueError("mesh_scene: empty face list")
    m = _SceneAssembler
    a = _SceneAssembler()
    g = a.geo
    mat = m.plastic(_f32([0.20, 0.22, 0.26]), _full(0.5), 64.0) \
        if material is None else material

    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    c = 0.5 * (lo + hi)
    extent = float(np.linalg.norm(hi - lo))
    extent = extent if extent > 0 else 1.0

    tri = verts[faces]                                    # (F, 3, 3)
    area2 = np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    kept = 0
    for f in range(len(faces)):
        if area2[f] <= 1e-12 * extent * extent:
            continue                                      # degenerate face
        a.surface(g.add_triangle(tri[f, 0], tri[f, 1], tri[f, 2]), mat)
        kept += 1
    if kept == 0:
        raise ValueError("mesh_scene: every face was degenerate")

    if ground:
        half = 2.5 * extent
        y0 = float(lo[1])
        a.surface(g.add_rectangle((c[0] - half, y0, c[2] - half),
                                  (c[0] - half, y0, c[2] + half),
                                  (c[0] + half, y0, c[2] + half),
                                  (c[0] + half, y0, c[2] - half)),
                  m.matte(_full(0.6)))

    emit = _full(28.0 * float(light_scale))
    c_l = (float(c[0] - 0.7 * extent), float(hi[1] + 1.4 * extent),
           float(c[2] + 0.5 * extent))
    r_l = 0.25 * extent
    slot = a.add_light(kind=klights.AREA_SPHERE, emit=emit,
                       center=np.asarray(c_l), radius=r_l)
    a._lights[slot]["surface_handle"] = a.surface(
        g.add_sphere(c_l, r_l), m.matte(_full(0.0)), emission=emit,
        light_slot=slot)
    a.add_light(kind=klights.ENV, emit=_f32([0.12, 0.14, 0.20]))

    cam = kscene.make_camera(
        position=(c[0], c[1] + 0.45 * extent, c[2] + 1.35 * extent),
        front=(0.0, -0.3, -1.0), up=(0.0, 1.0, 0.0),
        fov_degrees=45.0, width=width, height=height)
    return a.build(cam)
