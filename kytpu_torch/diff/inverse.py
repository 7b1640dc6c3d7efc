"""Inverse rendering: differentiable renders, their loss and the train step
(kytpu/diff/inverse.py on one device).

The estimator uses detached sampling: every sampled direction, pdf, lobe and
Russian-roulette decision is a constant of the forward, so the gradient of
the Monte Carlo estimate with respect to the material colours, emission and
environment radiance is itself an unbiased estimate of the gradient of the
true radiance.

Two families of steps. engine="cuda" (the port's default) is kytpu's
engine="pallas": the forward of a step is the residual megakernel K2 and
its backward the coefficient-cache kernel K3 (kernels/wavefront.py,
`make_cuda_diff_tracer`), with names=(..., "mat_exponent") too: kytpu's
step passes no `backward=` and so stays on the residual backward, whatever
its docstring says of the replay kernel. engine="jnp" ("fast" and "path"
are its aliases; the cfg's type picks the integrator) renders through the
torch engines (`render_once`, integrator/render.py `trace_lanes`) and takes
the gradient by torch autograd. `mesh=` shards either step over a
("tile", "spp") process mesh (kytpu_torch/dist), as kytpu's does.

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

import numpy as np
import torch
import torch.distributed as dist

from kytpu_torch.core import rng as krng
from kytpu_torch.core.device import check_device
from kytpu_torch.diff import losses as klosses
from kytpu_torch.diff.params import TRAINABLE, get_params, make_codec, set_params
from kytpu_torch.dist import shard as kshard
from kytpu_torch.integrator import path as kpath
from kytpu_torch.integrator.render import JNP_ENGINES, trace_lanes
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import scene as kscene
from kytpu_torch.utils import profiling as kprof


def _lane_ids(w: int, h: int, spp: int, device):
    """(px, py, pixel ids, sample ids) of spp samples of every pixel:
    pixel ids tiled, sample ids repeated."""
    npix = w * h
    pid = torch.arange(npix, device=device).repeat(spp)
    sid = torch.arange(spp, device=device).repeat_interleave(npix)
    return (pid % w).float(), (pid // w).float(), pid, sid


def render_once(scene, key, spp: int, cfg, device="cuda") -> torch.Tensor:
    """One pass of spp samples a pixel through the jnp engines -> (H, W, 3)
    on `device` (the card unless device="cpu"), unclamped and
    differentiable. The mean sums each pixel's samples in sample order,
    then scales by float32(1 / spp), as kytpu's jitted mean does."""
    scene = scene.to(check_device(device))
    cam = scene.camera
    w, h = cam.width, cam.height
    px, py, pid, sid = _lane_ids(w, h, spp, scene.device)
    out = trace_lanes(scene, key.to(scene.device), px, py, pid, sid, cfg,
                      "path", None).reshape(spp, h, w, 3)
    acc = out[0]
    for s in range(1, spp):
        acc = acc + out[s]
    return acc * float(np.float32(1.0 / spp))


def render_loss(params: dict, scene, target, key, spp: int, cfg,
                loss_fn=klosses.relmse) -> torch.Tensor:
    """loss_fn of render_once on the scene with `params`, where the scene
    lives."""
    return loss_fn(render_once(set_params(scene, params), key, spp, cfg,
                               scene.device), target)


def _mesh_lanes(mesh, w: int, h: int, spp: int, target):
    """Under a mesh: (this rank's pixel ids (p_loc,), its sample ids
    (s_loc,), its strip of the target (p_loc, 3)); kytpu's step asks that
    the tiles split the pixels and the spp axis the samples."""
    npix = w * h
    if npix % mesh.shape["tile"] or spp % mesh.shape["spp"]:
        raise ValueError(f"pixels {npix} / spp {spp} not divisible by mesh "
                         f"{mesh.shape}")
    pid, p0, _ = kshard.strip_of(mesh, npix)
    return (pid, kshard.slice_of(mesh, 0, spp),
            target.reshape(-1, 3)[p0:p0 + pid.shape[0]])


def _jnp_mesh_loss(scene, target, spp: int, cfg, loss_fn, mesh):
    """The jnp engines' loss of (params, key) on this rank of a mesh
    (kytpu's _sharded_loss): its strip's samples summed in sample order,
    summed over its tile's ranks (`kshard.sum_over`), scaled by
    float32(1 / spp) as render_once scales, and the loss of the strip
    against the target's; on a 1x1 mesh render_loss's value to the bit."""
    w, h = scene.camera.width, scene.camera.height
    pid, sid, target_strip = _mesh_lanes(mesh, w, h, spp, target)
    s_loc, p_loc = sid.shape[0], pid.shape[0]
    lane_pid = pid.repeat(s_loc)
    lane_sid = sid.repeat_interleave(p_loc)
    px, py = (lane_pid % w).float(), (lane_pid // w).float()
    scale = float(np.float32(1.0 / spp))

    def loss_of(p: dict, key: torch.Tensor) -> torch.Tensor:
        out = trace_lanes(set_params(scene, p), key.to(scene.device), px, py,
                          lane_pid, lane_sid, cfg, "path",
                          None).reshape(s_loc, p_loc, 3)
        acc = out[0]
        for s in range(1, s_loc):
            acc = acc + out[s]
        return loss_fn(kshard.sum_over(acc, mesh.spp_group) * scale,
                       target_strip)

    return loss_of


def _kernel_loss(scene, target, spp: int, max_depth: int, loss_fn, names,
                 kernel_sampler, mesh=None):
    """engine="cuda"'s loss of (params, key): kytpu's trace_block over all
    spp x npix lanes through the diff tracer (K2 and K3, or K6 and K7 past
    64 surfaces where the big-scene tables take the scene), then the loss
    of the mean image. Under a mesh, this rank's strip times its sample
    slice: the mean of its samples times s_loc / spp (1.0 on a 1x1 mesh),
    summed over its tile's ranks (`kshard.sum_over`), and the loss of the
    strip against the target's."""
    kcfg = kwf.KernelConfig(max_depth=max_depth,
                            trainable_exponent="mat_exponent" in names,
                            sampler=kernel_sampler or "random")
    kwf.check_config(kcfg)
    device = scene.device
    # scene-scale routing (kytpu's rule, kytpu/diff/inverse.py): past 64
    # surfaces the big-scene kernels K6 and K7 unless building their tracer
    # refuses the scene, then K2 and K3
    tracer = None
    if int(scene.mat_kind.shape[0]) > kwf.TABLE_ROUTE_SURFACES:
        try:
            tracer = kbs.make_bigscene_diff_tracer(scene, kcfg)
        except NotImplementedError:
            tracer = None
    if tracer is None:
        tracer = kwf.make_cuda_diff_tracer(scene, kcfg)
    for n, there in (("tex_color_a", tracer.tabs.textured),
                     ("tex_color_b", tracer.tabs.textured),
                     ("tex_image", tracer.tabs.has_img)):
        if n in names and not there:
            raise ValueError(f"{n}: no surface of the scene reads such a "
                             "texture")
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    env0 = (scene.env_radiance_ if scene.has_env
            else torch.zeros(3, device=device))
    if mesh is None:
        pid, sid = (torch.arange(npix, device=device),
                    torch.arange(spp, device=device))
    else:
        pid, sid, target = _mesh_lanes(mesh, w, h, spp, target)
    s_loc, p_loc = sid.shape[0], pid.shape[0]
    lane_pid = pid.repeat(s_loc)
    lane_sid = sid.repeat_interleave(p_loc)

    def loss_of(p: dict, key: torch.Tensor) -> torch.Tensor:
        with kprof.span("kytpu::rays"):
            seed = krng.randint(key, 0, 2**31 - 1)
            key = key.to(device)
            if kcfg.sampler == "sobol":
                u = krng.uniform2(krng.fold_in(key, lane_pid), "sobol",
                                  lane_sid)
                extra = (lane_sid.to(torch.int32), lane_pid.to(torch.int32))
            elif kcfg.sampler == "hash":
                u = krng.uniform(krng.fold_in(key, lane_sid * npix
                                              + lane_pid), (2,))
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
        if mesh is None:
            img = out.reshape(spp, npix, 3).mean(dim=0)
            return loss_fn(img.reshape(h, w, 3), target)
        part = out.reshape(s_loc, p_loc, 3).mean(dim=0) * (s_loc / spp)
        return loss_fn(kshard.sum_over(part, mesh.spp_group), target)

    return loss_of


def make_train_step(scene, target, spp: int = 4, max_depth: int = 3,
                    optimizer=None, loss_fn=klosses.relmse,
                    engine: str = "cuda", param_spaces: dict | None = None,
                    names: tuple | None = None,
                    kernel_sampler: str | None = None, device="cuda",
                    mesh=None, cfg=None):
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
    samples of every pixel through the engine, takes one optimizer step
    and clamps the parameters to >= 0, advancing `params` and the
    optimizer IN PLACE; `key` is a `core.rng` key (e.g.
    `rng.fold_in(rng.key(seed), i)`), from which the camera jitter and the
    kernel seed are drawn as kytpu draws them. The loss is returned as a
    0-dim tensor on `device`.

    `kernel_sampler` is "random" (default), "hash" or "sobol"; under
    "sobol" lane (sample s, pixel q) jitters with point s of pixel q's
    Owen-Sobol sequence, uniform2(fold_in(key, q), "sobol", s). The step
    runs on the card unless device="cpu", which runs the kernels' plain
    versions (engine="cuda") or the jnp engines on CPU tensors.

    `cfg` is the integrator's configuration, PathConfig(max_depth=
    max_depth) by default: engine="cuda" reads its max_depth, the jnp
    engines ("jnp", or its aliases "fast" and "path") render through it
    (`render_loss`; a FastConfig selects the fast engine), and their step
    differentiates by torch autograd.

    `mesh` (a `dist.mesh.Mesh`, every rank of its group calling this and
    each step in turn) shards the step over ("tile", "spp") as kytpu's
    does: each rank renders its strip of pixels times its slice of the
    samples on the mesh's device, its tile's ranks sum their images (one
    all_reduce, whose backward is the identity), the loss is the mean
    over tiles of each tile's loss on its strip, the parameter gradients
    are summed over every rank once and divided by the tiles, and every
    rank takes the same optimizer step on the same replicated parameters.
    engine="cuda" then needs kernel_sampler "hash" (its default under a
    mesh) or "sobol", whose lanes do not depend on the decomposition. On
    a 1x1 mesh the step is the unsharded one to the bit."""
    if engine not in ("cuda",) + JNP_ENGINES:
        raise ValueError(f"unknown engine {engine!r}: expected one of "
                         f"{('cuda',) + JNP_ENGINES}")
    cfg = cfg or kpath.PathConfig(max_depth=max_depth)
    names = tuple(names or TRAINABLE)
    device = mesh.device if mesh is not None else check_device(device)
    scene = scene.to(device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    if engine == "cuda":
        if mesh is not None:
            kernel_sampler = kernel_sampler or "hash"
            if kernel_sampler not in ("hash", "sobol"):
                raise ValueError(
                    "the sharded kernel step needs a decomposition-"
                    f"invariant sampler ('hash' or 'sobol'); got "
                    f"{kernel_sampler!r}")
        loss_of = _kernel_loss(scene, target, spp, cfg.max_depth, loss_fn,
                               names, kernel_sampler, mesh)
    elif mesh is not None:
        loss_of = _jnp_mesh_loss(scene, target, spp, cfg, loss_fn, mesh)
    else:
        def loss_of(p: dict, key: torch.Tensor) -> torch.Tensor:
            return render_loss(p, scene, target, key, spp, cfg, loss_fn)

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

    def step(key: torch.Tensor) -> torch.Tensor:
        with kprof.span("kytpu::train.step"):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_of(decode(theta), key)
            with kprof.span("kytpu::autograd.backward"):
                loss.backward()
            if mesh is not None:
                loss = _mesh_reduce(mesh, theta, loss)
            with kprof.span("kytpu::optim.step"):
                optimizer.step()
                with torch.no_grad():
                    for n, th in theta.items():
                        p = torch.clamp_min(decode({n: th})[n], 0.0)
                        if th is not params[n]:
                            th.copy_(encode({n: p})[n])
                        params[n].copy_(p)
            return loss.detach()

    return step, params, optimizer


def _mesh_reduce(mesh, theta: dict, loss: torch.Tensor) -> torch.Tensor:
    """After this rank's backward: each leaf's gradient summed over every
    rank and divided by the tiles (kytpu's pmean over "tile" of the tile
    losses), so every rank holds the same gradient; -> the mean of the
    tile losses."""
    n_tile = mesh.shape["tile"]
    for th in theta.values():
        if th.grad is None:
            th.grad = torch.zeros_like(th)
        dist.all_reduce(th.grad)
        th.grad.div_(n_tile)
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=mesh.tile_group)
    return loss.div_(n_tile)


def recover(scene, target, n_steps: int = 100, seed: int = 0,
            device="cuda", **kw):
    """Run an inverse-rendering loop -> (recovered scene on `device`,
    losses)."""
    step, params, _ = make_train_step(scene, target, device=device, **kw)
    key = krng.key(seed)
    hist = [float(step(krng.fold_in(key, i))) for i in range(n_steps)]
    return set_params(scene.to(device), params), hist
