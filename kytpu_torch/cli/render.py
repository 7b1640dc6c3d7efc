"""Config-driven render programs (kytpu/cli/render.py).

The reference's six render programs (ky.cpp:4675-4905) and three scenes
beyond it, as subcommands of `python -m kytpu_torch.cli.render`:

  single     render_single_scene  (ky.cpp:4675-4713): 1024^2 Cornell box,
             both small spheres + environment light, PT-iteration depth 5.
  debug      render_debug         (ky.cpp:4715-4738): 1x3 AOV grid
             (position/normal/basecolor) over the Veach scene.
  integrators render_multiple_integrator (ky.cpp:4740-4777): 4 Cornell light
             variants x 5 integrators montage.
  strategies render_direct_sample_enum   (ky.cpp:4779-4817): 4 light variants
             x 5 direct-sampling strategies montage.
  scenes     render_multiple_scene       (ky.cpp:4819-4876): 3 strategies x
             4 scenes montage.
  mis        render_mis_scene            (ky.cpp:4878-4905): 2x3 grid of the
             6 strategies over the Veach MIS scene.
  textured, spheres, trimesh: a textured Cornell box, many spheres, a
             triangle mesh.

Every subcommand renders on the card unless --device cpu, and accepts --mesh
t,s to render over a ("tile", "spp") mesh of t*s processes (under torchrun,
or 1,1 in one process; only rank 0 prints and writes). --engine pallas
(kytpu's name) runs the H100 kernels (render(engine="cuda"): K1, or K5 past
64 surfaces) in `single` and `trimesh`; the other subcommands render through
the jnp engines whatever --engine says, as kytpu's do.
"""

from __future__ import annotations

import argparse
import time

from kytpu_torch.cli.common import is_root, join_mesh, say
from kytpu_torch.cli.inverse import demo_texture
from kytpu_torch.film import io as fio
from kytpu_torch.film.film import FilmGrid
from kytpu_torch.integrator.path import PathConfig
from kytpu_torch.integrator.render import render
from kytpu_torch.scene import builders

# kytpu's engine names -> render()'s
_ENGINES = {"jnp": "jnp", "pallas": "cuda", "bigscene": "bigscene"}


def _render(args, scene, spp, cfg=None, mode="path", aov=None,
            engine="jnp"):
    """One frame -> (H, W, 3) tensor on the device: through the sharded
    renderers under --mesh, else render(); modes other than "path" run on
    the jnp engine."""
    if args.mesh is not None:
        from kytpu_torch.dist import render_sharded, render_sharded_pallas
        m = join_mesh(args.mesh, args.device)
        if engine == "pallas":
            from kytpu_torch.kernels.wavefront import KernelConfig
            kcfg = KernelConfig(max_depth=getattr(cfg, "max_depth", 5))
            return render_sharded_pallas(scene, m, spp=spp, seed=args.seed,
                                         kernel_cfg=kcfg)
        return render_sharded(scene, m, spp=spp, seed=args.seed, cfg=cfg,
                              mode=mode, aov=aov)
    return render(scene, spp=spp, seed=args.seed, cfg=cfg, mode=mode,
                  aov=aov, engine=_ENGINES[engine] if mode == "path"
                  else "jnp", device=args.device)


def _save(path: str, img) -> None:
    if is_root():
        fio.write_image(path, img)
        print(f"wrote {path}", flush=True)


# the four Cornell lighting variants used by the matrix subcommands
# (lighting_enum_t x cornell_box_enum_t, ky.cpp:4744-4756)
_CORNELL_VARIANTS = [
    ("area", builders.BOTH_SMALL_SPHERES | {builders.LIGHT_AREA}),
    ("direction", builders.BOTH_SMALL_SPHERES | {builders.LIGHT_DIRECTION}),
    ("point", builders.BOTH_SMALL_SPHERES | {builders.LIGHT_POINT}),
    ("environment",
     builders.BOTH_SMALL_SPHERES | {builders.LIGHT_ENVIRONMENT}),
]

_INTEGRATORS = [  # integrator_enum_t subset used by the matrix (ky.cpp:4762)
    ("direct", dict(mode="direct")),
    ("simple", dict(cfg_kw=dict(variant="simple"))),
    ("recursion", dict(cfg_kw=dict(variant="recursion"))),
    ("defered", dict(cfg_kw=dict(variant="defered"))),
    ("iteration", dict(cfg_kw=dict(variant="iteration"))),
]

_STRATEGIES = ["bsdf", "light", "bsdf_mis", "light_mis", "both_mis"]


def single_scene(size: int):
    """`single`'s scene: the Cornell box with both small spheres, the area
    and the environment light."""
    flags = builders.BOTH_SMALL_SPHERES | {builders.LIGHT_ENVIRONMENT,
                                           builders.LIGHT_AREA}
    return builders.cornell_box(flags, width=size, height=size)


def single_config(args) -> PathConfig:
    return PathConfig(max_depth=args.depth, variant="iteration",
                      strategy="both_mis", sampler=args.sampler,
                      filter=args.filter)


def cmd_single(args):
    scene = single_scene(args.size)
    t0 = time.perf_counter()
    img = _render(args, scene, args.spp, single_config(args),
                  engine=args.engine)
    dt = time.perf_counter() - t0
    say(f"{dt:.3f} seconds, {args.size}x{args.size} @ {args.spp} spp")
    _save(args.out or "single.bmp", img)
    return img


def cmd_debug(args):
    scene = builders.veach_mis(width=args.size, height=args.size * 308 // 512)
    grid = FilmGrid(1, 3, scene.camera.width, scene.camera.height)
    for aov in ("position", "normal", "basecolor"):
        grid.place(_render(args, scene, args.spp, mode="aov", aov=aov))
    _save(args.out or "render_debug.bmp", grid.pixels)
    return grid.pixels


def cmd_integrators(args):
    grid = FilmGrid(len(_CORNELL_VARIANTS), len(_INTEGRATORS),
                    args.size, args.size)
    for _, flags in _CORNELL_VARIANTS:
        scene = builders.cornell_box(flags, width=args.size, height=args.size)
        for _, spec in _INTEGRATORS:
            cfg = PathConfig(max_depth=args.depth, strategy="both_mis",
                             **spec.get("cfg_kw", {}))
            grid.place(_render(args, scene, args.spp, cfg,
                               mode=spec.get("mode", "path")))
    _save(args.out or "integrators.bmp", grid.pixels)
    return grid.pixels


def cmd_strategies(args):
    grid = FilmGrid(len(_CORNELL_VARIANTS), len(_STRATEGIES),
                    args.size, args.size)
    for _, flags in _CORNELL_VARIANTS:
        scene = builders.cornell_box(flags, width=args.size, height=args.size)
        for s in _STRATEGIES:
            cfg = PathConfig(max_depth=args.depth, strategy=s)
            grid.place(_render(args, scene, args.spp, cfg))
    _save(args.out or "strategies.bmp", grid.pixels)
    return grid.pixels


def cmd_scenes(args):
    """3 strategies x 4 lighting variants (render_multiple_scene,
    ky.cpp:4819-4876): {point x10, direction x40, area x40, environment x10}
    spp x {bsdf, light, both_mis}, both small spheres in every cell. The
    per-scene spp factors are the reference's (scaled by --spp / 40)."""
    variants = [
        (builders.LIGHT_POINT, 10),
        (builders.LIGHT_DIRECTION, 40),
        (builders.LIGHT_AREA, 40),
        (builders.LIGHT_ENVIRONMENT, 10),
    ]
    strategies = ["bsdf", "light", "both_mis"]
    grid = FilmGrid(len(strategies), len(variants), args.size, args.size)
    for s in strategies:
        for flag, spp_ref in variants:
            scene = builders.cornell_box(
                builders.BOTH_SMALL_SPHERES | {flag},
                width=args.size, height=args.size)
            cfg = PathConfig(max_depth=args.depth, strategy=s)
            spp = max(1, spp_ref * args.spp // 40)
            grid.place(_render(args, scene, spp, cfg))
    _save(args.out or "multi_scene.bmp", grid.pixels)
    return grid.pixels


def cmd_textured(args):
    """Texture demo: Cornell with a checkered floor and a painted back-wall
    image texture."""
    scene = builders.cornell_box(
        builders.BOTH_SMALL_SPHERES | {builders.LIGHT_AREA},
        width=args.size, height=args.size,
        floor_checker=True, back_image=demo_texture(32))
    cfg = PathConfig(max_depth=args.depth, strategy="both_mis",
                     sampler=args.sampler)
    t0 = time.perf_counter()
    img = _render(args, scene, args.spp, cfg)
    say(f"{time.perf_counter() - t0:.3f} seconds (textured cornell)")
    _save(args.out or "textured.bmp", img)
    return img


def cmd_spheres(args):
    """Many-sphere demo (builders.random_spheres) through the fast engine.
    Its "auto" accel resolves to the sweep, so it prints "sweep"
    (kytpu's docstring says "auto" takes the grid past 256 surfaces; its
    code does not)."""
    scene = builders.random_spheres(n=args.n, width=args.size,
                                    height=args.size, seed=args.seed)
    cfg = PathConfig(max_depth=args.depth, strategy="both_mis")
    t0 = time.perf_counter()
    img = _render(args, scene, args.spp, cfg, mode="fast")
    dt = time.perf_counter() - t0
    accel = "grid" if scene.accel is not None else "sweep"
    say(f"{dt:.3f} seconds, {scene.geometry.n_surfaces} surfaces "
        f"({accel})")
    _save(args.out or "spheres.bmp", img)
    return img


def cmd_trimesh(args):
    """Triangle-mesh demo (scene/mesh.py): an icosphere, a torus or an OBJ
    file on a ground plane. With --engine pallas the scene routes to the
    big-scene kernel K5 past 64 faces where its tables take it."""
    from kytpu_torch.scene import mesh as kmesh
    if args.obj:
        v, f = kmesh.load_obj(args.obj)
        label = args.obj
    elif args.shape == "torus":
        v, f = kmesh.torus(nu=2 * args.res, nv=args.res)
        label = f"torus({2 * args.res}x{args.res})"
    else:
        v, f = kmesh.icosphere(args.sub)
        label = f"icosphere({args.sub})"
    scene = builders.mesh_scene(v, f, width=args.size,
                                height=args.size * 2 // 3)
    cfg = PathConfig(max_depth=args.depth, strategy="both_mis",
                     sampler=args.sampler)
    t0 = time.perf_counter()
    img = _render(args, scene, args.spp, cfg,
                  mode="fast" if args.engine == "jnp" else "path",
                  engine=args.engine)
    say(f"{time.perf_counter() - t0:.3f} seconds, {len(f)} triangles "
        f"({label}, engine={args.engine})")
    _save(args.out or "trimesh.bmp", img)
    return img


def cmd_mis(args):
    w = args.size
    h = args.size * 308 // 512
    scene = builders.veach_mis(width=w, height=h)
    grid = FilmGrid(2, 3, w, h)
    for s in ("bsdf", "light", "idle", "bsdf_mis", "light_mis", "both_mis"):
        cfg = PathConfig(max_depth=args.depth, strategy=s)
        grid.place(_render(args, scene, args.spp, cfg))
    _save(args.out or "veach_mis.bmp", grid.pixels)
    return grid.pixels


COMMANDS = dict(single=cmd_single, debug=cmd_debug,
                integrators=cmd_integrators, strategies=cmd_strategies,
                scenes=cmd_scenes, mis=cmd_mis, textured=cmd_textured,
                spheres=cmd_spheres, trimesh=cmd_trimesh)
# (size, spp) of each subcommand
DEFAULTS = dict(single=(1024, 16), debug=(512, 10), integrators=(256, 16),
                strategies=(256, 16), scenes=(256, 16), mis=(512, 10),
                textured=(512, 64), spheres=(512, 32), trimesh=(384, 24))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kytpu_torch.cli.render",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in COMMANDS.items():
        sp = sub.add_parser(name)
        size0, spp0 = DEFAULTS[name]
        sp.add_argument("--size", type=int, default=size0)
        sp.add_argument("--spp", type=int, default=spp0)
        sp.add_argument("--depth", type=int, default=5)
        sp.add_argument("--seed", type=int, default=1234)
        sp.add_argument("--out", type=str, default=None)
        sp.add_argument("--mesh", type=lambda s: tuple(map(int, s.split(","))),
                        default=None, help="t,s mesh shape for SPMD render")
        sp.add_argument("--engine", choices=("jnp", "pallas", "bigscene"),
                        default="jnp",
                        help="pallas = the H100 megakernel K1, or past 64 "
                             "surfaces the table kernel K5 where its tables "
                             "take the scene (the production estimator; "
                             "the strategy-matrix subcommands always use "
                             "the jnp engine); bigscene = K5 at any size")
        sp.add_argument("--sampler",
                        choices=("random", "stratified", "sobol", "debug"),
                        default="random",
                        help="sobol = Owen-scrambled (0,2)-sequences "
                             "(in-kernel under --engine pallas)")
        sp.add_argument("--filter", choices=("box", "tent"), default="box",
                        help="tent = smallpt's 2x2 tent camera filter "
                             "(jnp engines)")
        sp.add_argument("--device", default="cuda",
                        help="where to render: the card (default) or cpu")
        if name == "spheres":
            sp.add_argument("--n", type=int, default=512,
                            help="sphere count")
        if name == "trimesh":
            sp.add_argument("--shape", choices=("icosphere", "torus"),
                            default="torus")
            sp.add_argument("--sub", type=int, default=3,
                            help="icosphere subdivisions (20*4^s faces)")
            sp.add_argument("--res", type=int, default=24,
                            help="torus tube segments (faces = 4*res^2)")
            sp.add_argument("--obj", type=str, default=None,
                            help="render a Wavefront OBJ file instead")
        sp.set_defaults(fn=fn)
    return p


def main(argv=None):
    """Run one subcommand -> the image it wrote, as an array or a tensor."""
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
