"""SPD's "balls" scene, the sphereflake (E. Haines, "A Proposal for
Standard Graphics Environments", IEEE CG&A 7(11), 1987; balls.c of the
Standard Procedural Databases), built for the benchmark's reference from
its description in perfbench/configs/spd_balls.json, apart from the port's
builder: the directions by quaternions, the flake by an explicit stack.

The flake: the root at the origin, radius 0.5, axis +Z; each sphere below
the size factor has nine children of a third of its radius, tangent to it,
at c + (4/3) r u, u the nine cuboctahedron directions (±1, ±1, 0)/√2 and
permutations with a dot >= 0 against (1, 1, 1)/√3, turned onto +Z by the
shortest rotation, then onto the sphere's axis by the shortest rotation
from +Z (the identity at +Z, a half turn about +Y at -Z: balls.c's); a
child's axis is its u. Spheres in balls.c's output order: a sphere, then
each child's subtree. Values within SNAP of 0, and axes within SNAP of
±Z, are taken as exact.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference.frozen.light import lights as klights
from perfbench.reference.frozen.scene import builders as fb
from perfbench.reference.frozen.scene import scene as kscene

SNAP = 1e-9
# the configuration's `assumed` intensity of each point light (W/sr) and
# Phong exponent of the spheres
POINT_INTENSITY, SHININESS = 25.0, 1000.0


def _qmul(a, b):
    """Hamilton product of quaternions (w, x, y, z)."""
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _turn(q, v):
    """v turned by the unit quaternion q."""
    p = _qmul(_qmul(q, np.concatenate([[0.0], v])),
              q * np.array([1.0, -1.0, -1.0, -1.0]))
    return p[1:]


def _between(a, b):
    """The unit quaternion of the shortest rotation taking unit a to b
    (a half turn about +Y where they are opposite)."""
    c = float(np.dot(a, b))
    if c >= 1.0 - SNAP:
        return np.array([1.0, 0.0, 0.0, 0.0])
    if c <= -1.0 + SNAP:
        return np.array([0.0, 0.0, 1.0, 0.0])
    half = np.arccos(c) / 2.0
    axis = np.cross(a, b)
    return np.concatenate([[np.cos(half)],
                           np.sin(half) * axis / np.linalg.norm(axis)])


def _exact(x):
    return np.where(np.abs(x) < SNAP, 0.0, x)


def flake(size_factor: int):
    """(centres (n, 3), radii (n,)) in float64, balls.c's order."""
    z = np.array([0.0, 0.0, 1.0])
    diag = np.ones(3) / np.sqrt(3.0)
    q0 = _between(diag, z)
    ring = []
    for v in ((1, 1, 0), (1, -1, 0), (-1, 1, 0), (1, 0, 1), (1, 0, -1),
              (-1, 0, 1), (0, 1, 1), (0, 1, -1), (0, -1, 1)):
        ring.append(_exact(_turn(q0, np.asarray(v, float) / np.sqrt(2.0))))
    centres, radii = [], []
    stack = [(np.zeros(3), 0.5, z, 0)]
    while stack:
        c, r, axis, level = stack.pop()
        centres.append(c)
        radii.append(r)
        if level == size_factor:
            continue
        q = _between(z, axis)
        kids = []
        for u in ring:
            w = _exact(_turn(q, u))
            kids.append((_exact(c + (r + r / 3.0) * w), r / 3.0, w,
                         level + 1))
        stack.extend(reversed(kids))
    return np.stack(centres), np.asarray(radii)


def spd_balls(size_factor: int = 4, width: int = 512,
              height: int = 512) -> kscene.Scene:
    """The scene: a matte floor square at z = -0.5 (±12), colour (1, 0.75,
    0.33) x 0.8; the flake in plastic, diffuse (1, 0.9, 0.7) x 0.5,
    specular 0.5, Phong exponent SHININESS, a row a sphere; point lights
    at (4, 3, 2), (1, -4, 4), (-3, 1, 5) of POINT_INTENSITY; the sky
    (0.078, 0.361, 0.753) as a constant environment light; the camera at
    (2.1, 1.3, 1.7) towards the origin, up +Z, 45°."""
    A = fb._SceneAssembler
    a = A()
    g = a.geo
    s = 12.0
    a.surface(g.add_rectangle((s, s, -0.5), (-s, s, -0.5), (-s, -s, -0.5),
                              (s, -s, -0.5)),
              A.matte(fb._f32(np.array([1.0, 0.75, 0.33]) * 0.8)))
    diffuse = fb._f32(np.array([1.0, 0.9, 0.7]) * 0.5)
    for c, r in zip(*flake(size_factor)):
        a.surface(g.add_sphere(c, r),
                  A.plastic(diffuse, fb._full(0.5), SHININESS))
    for p in ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0)):
        a.add_light(kind=klights.POINT, emit=fb._full(POINT_INTENSITY),
                    position=np.asarray(p))
    a.add_light(kind=klights.ENV, emit=fb._f32([0.078, 0.361, 0.753]))
    cam = kscene.make_camera(position=(2.1, 1.3, 1.7),
                             front=(-2.1, -1.3, -1.7), up=(0.0, 0.0, 1.0),
                             fov_degrees=45.0, width=width, height=height)
    return a.build(cam)
