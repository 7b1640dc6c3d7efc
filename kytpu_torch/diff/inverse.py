"""Inverse rendering: the train step through the CUDA kernels
(kytpu/diff/inverse.py, its engine="pallas" branch on one device).

The estimator uses detached sampling: every sampled direction, pdf, lobe and
Russian-roulette decision is a constant of the forward, so the gradient of
the Monte Carlo estimate with respect to the material colours, emission and
environment radiance is itself an unbiased estimate of the gradient of the
true radiance. The forward of a step is the residual megakernel K2 and its
backward the coefficient-cache kernel K3 (kernels/wavefront.py,
`make_cuda_diff_tracer`), with names=(..., "mat_exponent") too: kytpu's
step passes no `backward=` and so stays on the residual backward, whatever
its docstring says of the replay kernel.

kytpu's `render_once`/`render_loss` (the jnp path engine) wait for ROADMAP
item M7; its sharded step (`mesh=`) for M10.

Past 64 surfaces the step runs the big-scene kernels instead where their
tables take the scene, as kytpu's does: K6 forward, K7 backward
(kernels/bigscene.py, `make_bigscene_diff_tracer`), the exponent and
texture leaves and all three samplers included; a scene the tables do not
take (a rect that is not a parallelogram, an atlas past their select
chain) trains on K2 and K3 at any size.

On a textured scene the kernels evaluate the textures, and
names=("tex_image",) or ("tex_color_a", "tex_color_b") recover an image
texture's texels or a checker's colours: K3 and K7 route a textured row's
diffuse adjoint to its texture.
"""

from __future__ import annotations

import torch

from kytpu_torch.core import rng as krng
from kytpu_torch.diff import losses as klosses
from kytpu_torch.diff.params import TRAINABLE, get_params, make_codec, set_params
from kytpu_torch.integrator.render import check_device
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import scene as kscene


def make_train_step(scene, target, spp: int = 4, max_depth: int = 3,
                    optimizer=None, loss_fn=klosses.relmse,
                    engine: str = "cuda", param_spaces: dict | None = None,
                    names: tuple | None = None,
                    kernel_sampler: str | None = None, device="cuda",
                    mesh=None):
    """Build (step, params, optimizer) for inverse rendering of `scene`
    against the (H, W, 3) image `target`.

    `params` maps each trainable name (`diff.params.TRAINABLE` unless
    `names` says otherwise; "env_radiance_" may be added for an environment
    scene, "mat_exponent" to recover Phong glossiness, which sets
    KernelConfig(trainable_exponent=True), and "tex_color_a",
    "tex_color_b", "tex_image" on a textured scene) to a tensor in natural
    space on `device`. The optimizer,
    `optimizer(list_of_leaves)` (default `torch.optim.Adam` with lr=2e-2),
    runs over their encoded form (`param_spaces`, e.g. {"emission": "log"};
    see `diff.params.make_codec`), leaf tensors it owns; for a linear-space
    name the leaf is `params[name]` itself. `step(key) -> loss` renders spp
    samples of every pixel through the kernels, takes one optimizer step
    and clamps the parameters to >= 0, advancing `params` and the
    optimizer IN PLACE; `key` is a `core.rng` key (e.g.
    `rng.fold_in(rng.key(seed), i)`), from which the camera jitter and the
    kernel seed are drawn as kytpu draws them. The loss is returned as a
    0-dim tensor on `device`.

    `kernel_sampler` is "random" (default), "hash" or "sobol"; under
    "sobol" lane (sample s, pixel q) jitters with point s of pixel q's
    Owen-Sobol sequence, uniform2(fold_in(key, q), "sobol", s). The step
    runs on the card unless device="cpu", which runs the kernels' plain
    versions."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: the sharded train step is ROADMAP item M10 "
            "(distribution) of the port")
    if engine in ("jnp", "fast", "path"):
        raise NotImplementedError(
            f"engine={engine!r}: the jnp engines are ROADMAP item M7 of the "
            "port")
    if engine != "cuda":
        raise ValueError(f"unknown engine {engine!r}: expected 'cuda'")
    names = tuple(names or TRAINABLE)
    kcfg = kwf.KernelConfig(max_depth=max_depth,
                            trainable_exponent="mat_exponent" in names,
                            sampler=kernel_sampler or "random")
    kwf.check_config(kcfg)
    device = check_device(device)
    scene = scene.to(device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    # scene-scale routing (kytpu's rule): past 64 surfaces the big-scene
    # kernels K6 and K7 where their tables take the scene, else K2 and K3
    extracted = kbs.table_route(scene)
    tracer = (kwf.make_cuda_diff_tracer(scene, kcfg) if extracted is None
              else kbs.make_bigscene_diff_tracer(scene, kcfg,
                                                 extracted=extracted))
    for n, there in (("tex_color_a", tracer.tabs.textured),
                     ("tex_color_b", tracer.tabs.textured),
                     ("tex_image", tracer.tabs.has_img)):
        if n in names and not there:
            raise ValueError(f"{n}: no surface of the scene reads such a "
                             "texture")

    encode, decode = make_codec(param_spaces)
    spaces = param_spaces or {}
    params = {n: p.detach().clone() for n, p in get_params(scene,
                                                             names).items()}
    theta = {n: (p if spaces.get(n, "linear") == "linear"
                 else encode({n: p})[n]).requires_grad_()
             for n, p in params.items()}
    if optimizer is None:
        optimizer = torch.optim.Adam(list(theta.values()), lr=2e-2)
    else:
        optimizer = optimizer(list(theta.values()))

    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    env0 = (scene.env_radiance_ if scene.has_env
            else torch.zeros(3, device=device))
    lane_pid = torch.arange(npix, device=device).repeat(spp)
    lane_sid = torch.arange(spp, device=device).repeat_interleave(npix)

    def loss_of(p: dict, key: torch.Tensor) -> torch.Tensor:
        """kytpu's trace_block over all spp x npix lanes, then the loss of
        the mean image."""
        seed = krng.randint(key, 0, 2**31 - 1)
        key = key.to(device)
        if kcfg.sampler == "sobol":
            u = krng.uniform2(krng.fold_in(key, lane_pid), "sobol", lane_sid)
            extra = (lane_sid.to(torch.int32), lane_pid.to(torch.int32))
        elif kcfg.sampler == "hash":
            u = krng.uniform(krng.fold_in(key, lane_sid * npix + lane_pid),
                             (2,))
            extra = (lane_sid.to(torch.int32), lane_pid.to(torch.int32))
        else:
            u = krng.uniform(key, (spp * npix, 2))
            extra = ()
        px = (lane_pid % w).to(torch.float32) + u[:, 0]
        py = (lane_pid // w).to(torch.float32) + u[:, 1]
        o, d = kscene.generate_rays(cam, torch.stack([px, py], -1))
        # kytpu's _tracer_params order: the exponent after emission, then
        # the texture tables
        exp_arg = (p["mat_exponent"],) if kcfg.trainable_exponent else ()
        tex_arg = ()
        if tracer.tabs.textured:
            tex_arg = (p.get("tex_color_a", scene.textures.color_a),
                       p.get("tex_color_b", scene.textures.color_b))
        if tracer.tabs.has_img:
            tex_arg += (p.get("tex_image", scene.textures.image),)
        out = tracer(p.get("mat_diffuse", scene.mat_diffuse),
                     p.get("mat_specular", scene.mat_specular),
                     p.get("emission", scene.emission), *exp_arg, *tex_arg,
                     p.get("env_radiance_", env0), o, d, seed, *extra)
        img = out.reshape(spp, npix, 3).mean(dim=0)
        return loss_fn(img.reshape(h, w, 3), target)

    def step(key: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of(decode(theta), key)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            for n, th in theta.items():
                p = torch.clamp_min(decode({n: th})[n], 0.0)
                if th is not params[n]:
                    th.copy_(encode({n: p})[n])
                params[n].copy_(p)
        return loss.detach()

    return step, params, optimizer


def recover(scene, target, n_steps: int = 100, seed: int = 0,
            device="cuda", **kw):
    """Run an inverse-rendering loop -> (recovered scene on `device`,
    losses)."""
    step, params, _ = make_train_step(scene, target, device=device, **kw)
    key = krng.key(seed)
    hist = [float(step(krng.fold_in(key, i))) for i in range(n_steps)]
    return set_params(scene.to(device), params), hist
