"""SPD's "tetra" scene, the tetrahedral pyramid (E. Haines, "A Proposal for
Standard Graphics Environments", IEEE CG&A 7(11), 1987; tetra.c of the
Standard Procedural Databases, after Glassner's pyramid, IEEE CG&A 4(10),
1984), built for the benchmark's reference from its description in
perfbench/configs/spd_tetra.json, apart from the port's builder: each leaf
tetrahedron from its base-4 digits, not by recursion.

The root: the regular tetrahedron of edge 2 with its base on z = 0, v0 =
(1, -1/√3, 0), v1 = (-1, -1/√3, 0), v2 = (0, 2/√3, 0), v3 = (0, 0,
2√(2/3)). Leaf number m (0 .. 4^L - 1, L = size_factor - 1) has the digits
d1 .. dL of m in base 4, most significant first; its corner is o = v0 +
Σ_l (v_{d_l} - v0) / 2^l and its vertex j is o + (vj - v0) / 2^L (the
corner tetrahedron d_l at each level, in tetra.c's order). Each leaf gives
its four faces, the face opposite vertex i the other three in ascending
order with the last two swapped where that winding faces vertex i. The
sums run on the vertices in units of (1, 1/√3, 2√(2/3)), where every term
is exact, and the coordinates are scaled once at the end.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference.frozen.light import lights as klights
from perfbench.reference.frozen.scene import builders as fb
from perfbench.reference.frozen.scene import scene as kscene

# the root's vertices in units of SCALE
ROOT = np.array([[1.0, -1.0, 0.0], [-1.0, -1.0, 0.0], [0.0, 2.0, 0.0],
                 [0.0, 0.0, 1.0]])
SCALE = np.array([1.0, 1.0 / np.sqrt(3.0), 2.0 * np.sqrt(2.0 / 3.0)])
# the configuration's `assumed` floor height, point light (W/sr, position),
# camera and colours
FLOOR_Z = -0.25
LIGHT, LIGHT_AT = 60.0, (4.0, -3.0, 6.0)
SKY = (0.078, 0.361, 0.753)
EYE, LOOK_AT = (2.4, -3.0, 2.0), (0.0, 0.0, 0.55)


def triangles(size_factor: int) -> np.ndarray:
    """(4^size_factor, 3, 3) float64: leaf by leaf in digit order, each
    leaf's faces in the order of their opposite vertex."""
    depth = size_factor - 1
    out = []
    for m in range(4 ** depth):
        digits = [(m >> (2 * (depth - 1 - l))) & 3 for l in range(depth)]
        o = ROOT[0].copy()
        for l, dl in enumerate(digits, 1):
            o = o + (ROOT[dl] - ROOT[0]) / 2.0 ** l
        leaf = [(o + (ROOT[j] - ROOT[0]) / 2.0 ** depth) * SCALE
                for j in range(4)]
        for i in range(4):
            a, b, c = (leaf[j] for j in range(4) if j != i)
            if np.dot(np.cross(b - a, c - a), a - leaf[i]) < 0.0:
                b, c = c, b
            out.append((a, b, c))
    return np.asarray(out)


def spd_tetra(size_factor: int = 6, width: int = 512,
              height: int = 512) -> kscene.Scene:
    """The scene: the matte floor square at z = FLOOR_Z (±12), colour (1,
    0.75, 0.33) x 0.8, first; the triangles, a one-sided matte row each,
    grey 0.8; a point light of LIGHT at LIGHT_AT; the sky as a constant
    environment light; the camera at EYE towards LOOK_AT, up +Z, 45°."""
    A = fb._SceneAssembler
    a = A()
    g = a.geo
    s, z = 12.0, FLOOR_Z
    a.surface(g.add_rectangle((s, s, z), (-s, s, z), (-s, -s, z), (s, -s, z)),
              A.matte(fb._f32(np.array([1.0, 0.75, 0.33]) * 0.8)))
    for p0, p1, p2 in triangles(size_factor):
        a.surface(g.add_triangle(p0, p1, p2), A.matte(fb._full(0.8)))
    a.add_light(kind=klights.POINT, emit=fb._full(LIGHT),
                position=np.asarray(LIGHT_AT))
    a.add_light(kind=klights.ENV, emit=fb._f32(SKY))
    cam = kscene.make_camera(position=EYE,
                             front=tuple(np.subtract(LOOK_AT, EYE)),
                             up=(0.0, 0.0, 1.0), fov_degrees=45.0,
                             width=width, height=height)
    return a.build(cam)
