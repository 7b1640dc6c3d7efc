"""Inverse-rendering demo: recover Cornell-box albedos and emission
(kytpu/cli/inverse.py).

Renders a target image with the true scene, perturbs the material and
emission tables, then descends back by gradient through the jnp engines
(torch autograd), as kytpu's demo does. Run:

  python -m kytpu_torch.cli.inverse --size 32 --spp 4 --steps 60 [--mesh 1,1]
  python -m kytpu_torch.cli.inverse --device cpu --size 8 --steps 2

Prints the loss curve and the final per-parameter recovery error. It runs
on the card unless --device cpu. --mesh t,s shards each step over a
("tile", "spp") mesh of t*s processes: under torchrun with t*s ranks, or in
one process as 1,1; only rank 0 prints and writes.

--mode texture runs the texture-recovery variant instead: the target scene
carries a painted image texture on the back wall; optimization starts from
a flat gray texture and recovers the texels through the render (bilinear
lookup is linear in the texels, so per-texel gradients are exact;
scene/texture.py).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from kytpu_torch.cli.common import is_root, join_mesh, say
from kytpu_torch.core import rng as krng
from kytpu_torch.diff import get_params, make_train_step, set_params
from kytpu_torch.diff.inverse import render_once
from kytpu_torch.integrator.path import PathConfig
from kytpu_torch.scene import builders
from kytpu_torch.utils import RenderTimer, save_checkpoint


def demo_texture(n: int = 16) -> np.ndarray:
    """A recognizable (n, n, 3) test pattern: RGB gradient + yellow ring."""
    y, x = np.mgrid[0:n, 0:n] / max(n - 1, 1)
    img = np.stack([x, y, 1.0 - 0.5 * (x + y)], -1)
    r = np.hypot(x - 0.5, y - 0.5)
    img[np.abs(r - 0.3) < 0.08] = (0.9, 0.9, 0.1)
    return img.astype(np.float32)


def _adam(lr: float):
    return lambda leaves: torch.optim.Adam(leaves, lr=lr)


def _optimize(args, step, params, optimizer, key, timer):
    """args.steps steps (fresh keys with --resample), printing the loss
    every 10 and checkpointing (params, optimizer state) every
    --checkpoint-every -> the losses."""
    rays_per_step = args.size**2 * args.spp
    losses = []
    for i in range(args.steps):
        step_key = krng.fold_in(key, 1 + i) if args.resample else key
        with timer.phase("optimize", rays=rays_per_step):
            loss = float(step(step_key))
        losses.append(loss)
        if i % 10 == 0 or i == args.steps - 1:
            say(f"step {i:4d}  loss {loss:.6f}")
        if (args.checkpoint and (i + 1) % args.checkpoint_every == 0
                and is_root()):
            save_checkpoint(args.checkpoint,
                            (params, optimizer.state_dict()), step=i + 1)
    return losses


def _target(args, scene, key, cfg, timer):
    target_spp = args.target_spp or (32 if args.resample else args.spp)
    with timer.phase("target", rays=args.size**2 * target_spp):
        return render_once(scene, key, spp=target_spp, cfg=cfg,
                           device=args.device).detach()


def run_texture_recovery(args) -> dict:
    """Recover a painted back-wall texture from renders."""
    cfg = PathConfig(max_depth=args.depth, strategy="both_mis")
    true_img = demo_texture(args.tex_res)
    scene = builders.cornell_box(width=args.size, height=args.size,
                                 back_image=true_img)
    key = krng.key(args.seed)
    timer = RenderTimer()
    target = _target(args, scene, key, cfg, timer)

    gray = np.full_like(true_img, 0.5)
    scene_w = builders.cornell_box(width=args.size, height=args.size,
                                   back_image=gray)
    mesh = join_mesh(args.mesh, args.device) if args.mesh else None
    step, params, optimizer = make_train_step(
        scene_w, target, spp=args.spp, cfg=cfg, engine="jnp",
        optimizer=_adam(args.lr), names=("tex_image",), device=args.device,
        mesh=mesh)
    losses = _optimize(args, step, params, optimizer, key, timer)
    got = params["tex_image"][0].detach().cpu().numpy()
    say(f"tex_image: mean abs error {np.abs(gray - true_img).mean():.4f}"
        f" -> {np.abs(got - true_img).mean():.4f}")
    say(timer.report())
    return dict(losses=losses, params=params, optimizer=optimizer,
                timer=timer)


def main(argv=None) -> dict:
    """Run the demo -> {"losses": each step's loss, "params": the trained
    leaves, "optimizer", "timer": its RenderTimer}."""
    p = argparse.ArgumentParser(prog="kytpu_torch.cli.inverse")
    p.add_argument("--mode", choices=("albedo", "texture"), default="albedo")
    p.add_argument("--tex-res", type=int, default=16,
                   help="texture resolution for --mode texture")
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target-spp", type=int, default=None,
                   help="spp of the synthetic target (defaults to --spp "
                        "for common-random-numbers mode, 32 with "
                        "--resample)")
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--recover-emission", action="store_true",
                   help="also halve+recover emission (harder: brightness "
                        "is partially ambiguous between albedo and "
                        "emission at low resolution)")
    p.add_argument("--emission-space", choices=("log", "linear"),
                   default="log",
                   help="optimize emission in softplus-log space (default: "
                        "one shared lr conditions albedo+emission jointly) "
                        "or linear space (an Adam parameter group with an "
                        "lr scaled by the emission's magnitude)")
    p.add_argument("--resample", action="store_true",
                   help="draw fresh sample paths every step (default keeps "
                        "common random numbers, the standard "
                        "variance-reduction for inverse rendering)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=20)
    p.add_argument("--mesh", type=lambda s: tuple(map(int, s.split(","))),
                   default=None)
    p.add_argument("--device", default="cuda",
                   help="where to render and train: the card (default) or "
                        "cpu")
    args = p.parse_args(argv)

    if args.mode == "texture":
        return run_texture_recovery(args)

    cfg = PathConfig(max_depth=args.depth, strategy="both_mis")
    scene = builders.cornell_box(width=args.size, height=args.size)
    key = krng.key(args.seed)
    timer = RenderTimer()
    target = _target(args, scene, key, cfg, timer)

    true = {n: v.cpu() for n, v in get_params(scene).items()}
    rng = np.random.default_rng(args.seed)
    # Perturb albedos (and optionally emission: magnitudes ~25, so it
    # gets a proportionally larger adam learning rate; adam steps are
    # unit-scaled per parameter and a shared lr could never close a
    # 12-unit gap).
    diffuse = true["mat_diffuse"].numpy()
    wrong = {
        "mat_diffuse": torch.from_numpy(np.clip(
            diffuse * rng.uniform(0.3, 1.6, diffuse.shape), 0, 1).astype(
                np.float32)),
        "mat_specular": true["mat_specular"],
        "emission": (true["emission"] * 0.5 if args.recover_emission
                     else true["emission"]),
    }
    scene_w = set_params(scene, wrong)
    mesh = join_mesh(args.mesh, args.device) if args.mesh else None

    # only optimize what was perturbed: without --recover-emission the
    # emission tables start at the truth, and training them anyway lets
    # MC noise walk them away from it (visible at small --steps)
    names = (("mat_diffuse", "mat_specular", "emission")
             if args.recover_emission else ("mat_diffuse", "mat_specular"))

    if args.emission_space == "log":
        # log-space emission: multiplicative steps, one shared lr suffices
        optimizer = _adam(args.lr)
        param_spaces = {"emission": "log"} if args.recover_emission else None
    else:
        # linear space needs a proportionally larger emission lr: the
        # leaves come in `names` order, emission in a group of its own
        emission_scale = float(true["emission"].max()) or 1.0

        def optimizer(leaves):
            groups = [{"params": [x for n, x in zip(names, leaves)
                                  if n != "emission"]}]
            if "emission" in names:
                groups.append({"params": [leaves[names.index("emission")]],
                               "lr": args.lr * emission_scale})
            return torch.optim.Adam(groups, lr=args.lr)
        param_spaces = None
    step, params, opt = make_train_step(
        scene_w, target, spp=args.spp, cfg=cfg, engine="jnp", mesh=mesh,
        optimizer=optimizer, param_spaces=param_spaces, names=names,
        device=args.device)
    losses = _optimize(args, step, params, opt, key, timer)

    report = ("mat_diffuse", "emission") if args.recover_emission \
        else ("mat_diffuse",)
    for name in report:
        err0 = float((wrong[name] - true[name]).abs().mean())
        got = params[name].detach().cpu()
        err1 = float((got - true[name]).abs().mean())
        say(f"{name}: mean abs error {err0:.4f} -> {err1:.4f}")
    say(timer.report())
    return dict(losses=losses, params=params, optimizer=opt, timer=timer)


if __name__ == "__main__":
    main()
