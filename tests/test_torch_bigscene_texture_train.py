"""Texture recovery past 64 surfaces: the port's make_train_step, which
routes a checker scene of 71 surfaces to the textured big-scene kernels
(the plain K6 and K7 here), against kytpu's engine="pallas" step, which
routes it to its table kernels (interpreted).

The scene (kytpu's own past-64 texture scene, as
test_torch_bigscene_tables.py builds it): a checkered ground rect, 70
spheres and the sky, 8x8. Three steps of names=("tex_color_a",
"tex_color_b") at spp 2, depth 2, kernel_sampler="hash", Adam lr 2e-2,
from 0.4 of the true colours, against a target the port renders of the
true scene at 16 spp; one key for all three steps. Tolerance: losses within
rtol=1e-5, parameters within atol=5e-5 (the bound of the other three-step
tests, test_torch_bigscene_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from kytpu.diff import inverse as jinv
from kytpu.integrator.path import PathConfig
from kytpu.scene import builders as jb
from kytpu_torch.core import rng as trng
from kytpu_torch.diff import inverse as tinv
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders as tb
import tests.torch_threads  # noqa: F401  (one torch thread a process)

NAMES = ("tex_color_a", "tex_color_b")


def checker_scene(b, scale=1.0, ground=None, image=None, parallelogram=True):
    """A ground rect (a checker by default, or an image texture, or
    untextured with ground="plain"), 70 spheres and the sky: 71 surfaces,
    kytpu's scene past 64 surfaces that its tables refuse only for the
    texture (test_torch_bigscene_tables.py)."""
    a = b._SceneAssembler()
    f3 = lambda v: np.full(3, v, np.float32)  # noqa: E731
    if image is not None:
        tex = a.add_image_texture(image, scale=(2.0, 2.0))
    elif ground != "plain":
        tex = a.add_checker(f3(0.2 * scale), f3(0.8 * scale) * np.float32(
            [1.0, 0.7, 0.4]), scale=(4.0, 4.0))
    else:
        tex = -1
    far = (9, 0, -9) if parallelogram else (5, 0, -9)
    a.surface(a.geo.add_rectangle((-9, 0, -9), (-9, 0, 9), (9, 0, 9), far),
              a.matte(f3(0.5), texture=tex))
    for k in range(70):
        a.surface(a.geo.add_sphere((k % 10 - 5.0, 0.3, k // 10 - 3.0), 0.2),
                  a.matte(f3(0.5)))
    a.add_light(kind=b.klights.ENV, emit=np.ones(3, np.float32))
    return a.build(b.kscene.make_camera((0, 3, 9), (0, -0.3, -1), (0, 1, 0),
                                        50.0, 8, 8))


def test_checker_steps_past_64_surfaces_match_kytpu(monkeypatch):
    target = render(checker_scene(tb), spp=16, seed=3, clamp=False,
                    device="cpu").numpy()
    jsc, tsc = checker_scene(jb, 0.4), checker_scene(tb, 0.4)
    step, params, opt = jinv.make_train_step(
        jsc, jnp.asarray(target), spp=2, cfg=PathConfig(max_depth=2),
        engine="pallas", kernel_sampler="hash", names=NAMES)
    key = jax.random.key(0)
    ref_losses, ref_params = [], []
    for _ in range(3):
        params, opt, loss = step(params, opt, key)
        ref_losses.append(float(loss))
        ref_params.append({k: np.asarray(v) for k, v in params.items()})

    built = []
    for mod, nm in ((kbs, "make_bigscene_diff_tracer"),
                    (kwf, "make_cuda_diff_tracer")):
        real = getattr(mod, nm)
        monkeypatch.setattr(mod, nm, lambda *a, real=real, nm=nm, **k: (
            built.append(nm), real(*a, **k))[1])
    tstep, tp, _ = tinv.make_train_step(tsc, target, spp=2, max_depth=2,
                                        kernel_sampler="hash", device="cpu",
                                        names=NAMES)
    assert built == ["make_bigscene_diff_tracer"]
    losses = []
    for i in range(3):
        losses.append(float(tstep(trng.key(0))))
        for name, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), ref_params[i][name],
                                       rtol=0, atol=5e-5, err_msg=name)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[0] > losses[1] > losses[2]
