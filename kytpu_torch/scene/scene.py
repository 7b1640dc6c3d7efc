"""Camera, scene container and ray generation (kytpu/scene/scene.py).

A `Scene` is a frozen dataclass of tensors that all live on one device
(`scene.device`; move it with `scene.to(device)`). The material, emission
and light-colour tables are this system's weights: a render reads them as
data, so new values need no new kernel. Host metadata (light kinds, the
environment flag) are plain python values.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from kytpu_torch.core import math as km
from kytpu_torch.light.lights import Lights
from kytpu_torch.scene import accel as kaccel
from kytpu_torch.scene import shapes as kshapes
from kytpu_torch.scene import texture as ktex


@dataclass(frozen=True)
class Camera:
    """Perspective pinhole camera (ky.cpp:1859-1906, left-handed basis);
    right/up are pre-scaled by tan(fov/2) (and the aspect ratio)."""

    position: torch.Tensor  # (3,)
    front: torch.Tensor     # (3,) unit
    right: torch.Tensor     # (3,) scaled
    up: torch.Tensor        # (3,) scaled
    width: int
    height: int

    def __post_init__(self):
        # front, right and up as nine python floats (not a field: the
        # tables mirror kytpu's), read where the camera is made on the host
        # and kept by `to`, so the rays kernel takes them as arguments with
        # no read from the card
        object.__setattr__(self, "_basis", self._read_basis()
                           if self.front.device.type == "cpu" else None)

    def _read_basis(self) -> tuple:
        return tuple(torch.cat([self.front, self.right, self.up]).tolist())

    def to(self, device) -> "Camera":
        cam = replace(self, position=self.position.to(device),
                      front=self.front.to(device),
                      right=self.right.to(device), up=self.up.to(device))
        if cam._basis is None:
            object.__setattr__(cam, "_basis", self._basis)
        return cam

    def host_basis(self) -> tuple:
        """front, right and up as nine python floats: kept from the host,
        or read from the card (one sync) for a camera made there."""
        return self._basis if self._basis is not None else self._read_basis()


def make_camera(position, front, up, fov_degrees, width, height) -> Camera:
    position = np.asarray(position, np.float32)
    front = np.asarray(front, np.float64)
    front = front / np.linalg.norm(front)
    up0 = np.asarray(up, np.float64)
    up0 = up0 / np.linalg.norm(up0)
    tan_fov = np.tan(np.radians(fov_degrees) / 2.0)
    aspect = width / height
    right = np.cross(up0, front)
    right = right / np.linalg.norm(right) * tan_fov * aspect
    up_scaled = np.cross(front, right)
    up_scaled = up_scaled / np.linalg.norm(up_scaled) * tan_fov
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return Camera(position=f32(position), front=f32(front), right=f32(right),
                  up=f32(up_scaled), width=int(width), height=int(height))


def generate_rays(cam: Camera, p_film: torch.Tensor):
    """p_film: (N, 2) film coordinates in [0,W)x[0,H) -> (o, d), each (N, 3).

    direction = front + right*(x/W - 0.5) + up*(0.5 - y/H), normalized
    (ky.cpp:1884-1892).

    It rounds as the JAX package's jitted frame renderers do (XLA on the
    CPU): x/W becomes x * float32(1/W), every multiply-add is fused and the
    norm is a fused multiply-add chain. Each fused step is taken in float64
    and rounded once to float32, so both packages trace the same rays."""
    f32, f64 = torch.float32, torch.float64

    def fma(a, b, c):   # round(a*b + c) to float32, a*b exact in float64
        return (a.to(f64) * b.to(f64) + c.to(f64)).to(f32)

    px, py = p_film[:, 0:1].to(f32), p_film[:, 1:2].to(f32)
    sx = fma(px, torch.tensor(1.0 / cam.width, dtype=f32), torch.tensor(-0.5))
    sy = fma(-py, torch.tensor(1.0 / cam.height, dtype=f32), torch.tensor(0.5))
    d = fma(sy, cam.up[None], fma(sx, cam.right[None], cam.front[None]))
    s = d[:, 0] * d[:, 0]
    s = fma(d[:, 1], d[:, 1], s)
    s = fma(d[:, 2], d[:, 2], s)
    d = d / km.sqrt(s)[:, None]
    o = cam.position[None].expand_as(d)
    return o, d


@dataclass(frozen=True)
class Scene:
    camera: Camera
    geometry: kshapes.Geometry
    # per-surface tables, row-aligned with the global surface index
    mat_kind: torch.Tensor      # (M,) int32 in MAT_*
    mat_diffuse: torch.Tensor   # (M,3)
    mat_specular: torch.Tensor  # (M,3)
    mat_exponent: torch.Tensor  # (M,)
    mat_eta: torch.Tensor       # (M,)
    mat_d_prob: torch.Tensor    # (M,) plastic lobe probabilities
    mat_s_prob: torch.Tensor    # (M,)
    emission: torch.Tensor      # (M,3) area-light radiance (zeros otherwise)
    light_index: torch.Tensor   # (M,) int32 light row, -1 if none
    lights: Lights
    world_center: torch.Tensor  # (3,)
    world_radius: torch.Tensor  # ()
    has_env: bool = False
    env_radiance_: torch.Tensor | None = None  # (3,)
    # textures: tex_id (M,) int32 is each surface's texture row, -1 for
    # none; the kernels read them on planar rows only
    has_textures: bool = False
    tex_id: torch.Tensor | None = None
    textures: ktex.Textures | None = None
    # the optional uniform-grid accelerator (scene/accel.py): where set,
    # the jnp engines' closest-hit and occlusion queries run its DDA in
    # place of the O(N) sweep
    accel: kaccel.Grid | None = None

    @property
    def n_lights(self) -> int:
        return len(self.lights.kinds)

    @property
    def device(self) -> torch.device:
        return self.mat_diffuse.device

    def diffuse_at(self, sid: torch.Tensor, uv: torch.Tensor):
        """Per-lane diffuse / transmission colour: the mat_diffuse row, or
        the bound texture's value where the row has one."""
        base = km.gather(self.mat_diffuse, sid)
        if not self.has_textures:
            return base
        tid = self.tex_id[sid.long()]
        tv = ktex.eval_texture(self.textures, torch.clamp_min(tid, 0), uv)
        return torch.where((tid >= 0)[:, None], tv, base)

    def env_radiance(self, n: int) -> torch.Tensor:
        """Environment radiance for n rays, 0 where the scene has no
        environment light (`scene_t::environment_lighting`,
        ky.cpp:3231-3237)."""
        if self.has_env:
            return self.env_radiance_[None].expand(n, 3)
        return torch.zeros((n, 3), dtype=torch.float32, device=self.device)

    def to(self, device) -> "Scene":
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v.to(device) if hasattr(v, "to") else v
        return Scene(**kw)


def scene_from_numpy(leaves) -> Scene:
    """Port a JAX-package `Scene` fetched with `jax.device_get` (numpy
    leaves plus its static fields, textures included) into a CPU `Scene`
    of this package.

    Reads attributes only, so this module never imports jax."""
    t = lambda a, dt=np.float32: torch.from_numpy(  # noqa: E731
        np.array(a, dtype=dt, copy=True))
    c = leaves.camera
    cam = Camera(position=t(c.position), front=t(c.front), right=t(c.right),
                 up=t(c.up), width=int(c.width), height=int(c.height))
    g = leaves.geometry
    geom = kshapes.Geometry(
        pl_kind=t(g.pl_kind, np.int32), pl_p0=t(g.pl_p0), pl_p1=t(g.pl_p1),
        pl_p2=t(g.pl_p2), pl_p3=t(g.pl_p3), pl_normal=t(g.pl_normal),
        pl_radius=t(g.pl_radius), pl_area=t(g.pl_area),
        sp_center=t(g.sp_center).reshape(-1, 3), sp_radius=t(g.sp_radius),
        sp_area=t(g.sp_area))
    li = leaves.lights
    lights = Lights(
        kinds=tuple(int(k) for k in li.kinds),
        surface_ids=tuple(int(s) for s in li.surface_ids),
        **{name: t(getattr(li, name)) for name in
           ("emit", "position", "direction", "p0", "p1", "p2", "p3",
            "normal", "area", "center", "radius")})
    tex = None
    if getattr(leaves, "textures", None) is not None:
        tx = leaves.textures
        tex = ktex.Textures(
            kind=t(tx.kind, np.int32), color_a=t(tx.color_a).reshape(-1, 3),
            color_b=t(tx.color_b).reshape(-1, 3),
            scale=t(tx.scale).reshape(-1, 2),
            image_index=t(tx.image_index, np.int32), image=t(tx.image))
    return Scene(
        camera=cam, geometry=geom,
        mat_kind=t(leaves.mat_kind, np.int32),
        mat_diffuse=t(leaves.mat_diffuse), mat_specular=t(leaves.mat_specular),
        mat_exponent=t(leaves.mat_exponent), mat_eta=t(leaves.mat_eta),
        mat_d_prob=t(leaves.mat_d_prob), mat_s_prob=t(leaves.mat_s_prob),
        emission=t(leaves.emission), light_index=t(leaves.light_index, np.int32),
        lights=lights, world_center=t(leaves.world_center),
        world_radius=t(leaves.world_radius), has_env=bool(leaves.has_env),
        env_radiance_=t(leaves.env_radiance_ if leaves.env_radiance_ is not None
                        else np.zeros(3)),
        has_textures=bool(getattr(leaves, "has_textures", False)),
        tex_id=(t(leaves.tex_id, np.int32)
                if getattr(leaves, "tex_id", None) is not None else None),
        textures=tex,
        accel=(kaccel.grid_from_numpy(leaves.accel)
               if getattr(leaves, "accel", None) is not None else None))


# ---------------------------------------------------------------------------
# intersection and material binding (the jnp engines')
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Hit:
    """Batched surface interactions (the reference's isect_t,
    ky.cpp:642-692). Every field is defined on every lane; `valid` masks
    the real hits, and a miss carries row 0's gathers, which the callers
    mask out."""

    t: torch.Tensor            # (N,)
    valid: torch.Tensor        # (N,) bool
    position: torch.Tensor     # (N,3)
    normal: torch.Tensor       # (N,3) the shapes' orientation rules applied
    wo: torch.Tensor           # (N,3) = -ray direction
    sid: torch.Tensor          # (N,) int32 global surface row
    emission: torch.Tensor     # (N,3) one-sided emitted radiance towards wo
    light_index: torch.Tensor  # (N,) int32 light of the hit surface, -1
    uv: torch.Tensor           # (N,2) texture coords (0 when untextured)


def intersect(scene: Scene, o, d, tmax=None) -> Hit:
    """The closest hit over the whole scene (through the grid where the
    scene has one) and its material and light binding."""
    n = o.shape[0]
    if tmax is None:
        tmax = torch.full((n,), km.INF, dtype=o.dtype, device=o.device)
    if scene.accel is not None:
        t, sid, valid = kaccel.grid_closest_hit(scene.accel, scene.geometry,
                                                o, d, tmax)
    else:
        t, sid, valid = kshapes.closest_hit(scene.geometry, o, d, tmax)
    t_safe = torch.where(valid, t, torch.ones_like(t))
    position = o + t_safe[:, None] * d
    normal = kshapes.surface_normal(scene.geometry, sid, position, d)
    wo = -d
    # one-sided emission towards wo under the (possibly flipped) hit normal,
    # as area_light_t::areal_radiance binds it (ky.cpp:2957-2960, 3084)
    facing = km.dot(normal, wo) > 0.0
    radiance = km.gather(scene.emission, sid)
    emission = torch.where((valid & facing)[:, None], radiance,
                           torch.zeros_like(radiance))
    light_index = torch.where(valid, scene.light_index[sid.long()], -1)
    if scene.has_textures:
        uv = kshapes.surface_uv(scene.geometry, sid, position)
    else:
        uv = torch.zeros((n, 2), dtype=o.dtype, device=o.device)
    return Hit(t=t, valid=valid, position=position, normal=normal, wo=wo,
               sid=sid, emission=emission, light_index=light_index, uv=uv)


def occluded(scene: Scene, position, normal, direction, dist):
    """Shadow rays from surface points (ky.cpp:3187-3206): an offset
    origin, tmax = dist - 2e-3.

    The reference's quirk, kept for pixel parity: `dist` is measured from
    the unoffset shading point while the ray starts at the offset origin
    (ky.cpp:614, 3193), so a sampled light's own surface re-enters the
    window where RAY_OFFSET cos(theta) > 2e-3. shadow="robust" takes
    `occluded_from` instead."""
    o = kshapes.offset_ray_origin(position, normal, direction)
    tmax = dist - km.SHADOW_EPSILON
    if scene.accel is not None:
        return kaccel.grid_any_hit(scene.accel, scene.geometry, o, direction,
                                   tmax)
    return kshapes.any_hit(scene.geometry, o, direction, tmax)


def occluded_from(scene: Scene, o, direction, tmax, skip_row=None):
    """Shadow rays with the caller's origin and tmax (the robust shadow
    mode: tmax from the offset origin, and the sampled light's own surface
    row left out by skip_row). The grid has no row exclusion, so a query
    with skip_row sweeps, as kytpu's does."""
    if skip_row is None and scene.accel is not None:
        return kaccel.grid_any_hit(scene.accel, scene.geometry, o, direction,
                                   tmax)
    return kshapes.any_hit(scene.geometry, o, direction, tmax, skip_row)


def spawn_ray(position, normal, direction):
    """The offset origin of a continuation ray (isect_t::spawn_ray,
    ky.cpp:665-668)."""
    return kshapes.offset_ray_origin(position, normal, direction)
