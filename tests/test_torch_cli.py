"""The port's command lines (kytpu_torch/cli) against kytpu's: every
render subcommand on the CPU, the files they write, their parsers against
kytpu's, and the inverse-rendering demo's losses and checkpoints.

Tolerance: against kytpu (on the torus, kytpu run eagerly: its jitted
triangle test drops hits), each subcommand's image and the inverse demo's
first loss within the jnp engines' bound, rtol 1e-3/atol 1e-4 on more
than 99.9% of values (the perturbation's printed error to its 4 digits).
Within the port none: `single`'s BMP equals the bytes of io.write_bmp of
render() with the same scene, config and seed (the jnp engine, and the
plain version of the kernel engine), under --mesh 1,1 too; the inverse
demo's first loss equals make_train_step's first loss to the bit.
"""

import argparse
import re
import struct

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import kytpu.cli.inverse as jinv
import kytpu.cli.render as jcli
from kytpu_torch.cli import inverse as tinv
from kytpu_torch.cli import render as tcli
from kytpu_torch.core import rng as trng
from kytpu_torch.diff import get_params, make_train_step, set_params
from kytpu_torch.diff.inverse import render_once
from kytpu_torch.dist import multihost
from kytpu_torch.film import io as tio
from kytpu_torch.integrator.path import PathConfig
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels.wavefront import KernelConfig
from kytpu_torch.scene import builders as tb
from kytpu_torch.utils import load_checkpoint
from kytpu_torch.utils.checks import validate_radiance
import tests.torch_threads  # noqa: F401  (one torch thread a process)

SMALL = ["--spp", "1", "--depth", "1", "--device", "cpu"]
# each subcommand at a small size -> (its arguments, the written image's (H, W))
RUNS = {
    "single": (["--size", "12"], (12, 12)),
    "debug": (["--size", "16"], (16 * 308 // 512, 48)),
    "integrators": (["--size", "8"], (32, 40)),
    "strategies": (["--size", "8"], (32, 40)),
    "scenes": (["--size", "8"], (24, 32)),
    "mis": (["--size", "16"], (2 * (16 * 308 // 512), 48)),
    "textured": (["--size", "12"], (12, 12)),
    "spheres": (["--size", "12", "--n", "30"], (12, 12)),
    "trimesh": (["--size", "12", "--res", "4"], (8, 12)),
}


def _bmp_size(h: int, w: int) -> int:
    return 54 + (w * 3 + (-w * 3) % 4) * h


@pytest.mark.parametrize("cmd", list(RUNS))
def test_subcommand_writes_its_image(cmd, tmp_path, capsys):
    extra, (h, w) = RUNS[cmd]
    out = tmp_path / f"{cmd}.bmp"
    img = tcli.main([cmd, *extra, *SMALL, "--out", str(out)])
    assert tuple(img.shape) == (h, w, 3)
    validate_radiance(img, cmd)
    data = out.read_bytes()
    assert len(data) == _bmp_size(h, w)
    assert struct.unpack("<ii", data[18:26]) == (w, h)
    assert f"wrote {out}" in capsys.readouterr().out


# each subcommand against kytpu's: (subcommand, the montage's frames that
# both sides render; None for all). The other frames are black on both
# sides, so that no case takes more than a few of kytpu's compiles.
AGAINST_KYTPU = ([(cmd, None) for cmd in ("single", "debug", "textured",
                                          "spheres", "trimesh")]
                 + [(cmd, range(5 * r, 5 * r + 5))
                    for cmd in ("integrators", "strategies") for r in range(4)]
                 + [("scenes", range(4 * r, 4 * r + 4)) for r in range(3)]
                 + [("mis", range(0, 3)), ("mis", range(3, 6))])


def _montage(monkeypatch, mod, frames, black):
    """Hook mod (a render CLI module): only the calls of its _render
    numbered in frames render, the others give black frames of their
    scene's size; _save keeps the image. -> (the kept images, the number
    of _render calls)."""
    real, calls, saved = mod._render, [], []

    def render(*a, **kw):
        scene = next(x for x in a if hasattr(x, "camera"))
        calls.append(len(calls))
        if frames is None or calls[-1] in frames:
            return real(*a, **kw)
        return black(scene.camera.height, scene.camera.width)

    monkeypatch.setattr(mod, "_render", render)
    monkeypatch.setattr(mod, "_save", lambda path, img: saved.append(img))
    return saved, calls


@pytest.mark.parametrize("cmd,frames", AGAINST_KYTPU, ids=[
    cmd if fr is None else f"{cmd}-{fr.start}-{fr.stop - 1}"
    for cmd, fr in AGAINST_KYTPU])
def test_subcommand_matches_kytpu(cmd, frames, monkeypatch):
    """kytpu's subcommand and the port's on the same arguments: the same
    scenes, configs, spp and montage order give kytpu's image."""
    argv = [cmd, *RUNS[cmd][0], "--spp", "1", "--depth", "1"]
    ref, n_ref = _montage(monkeypatch, jcli, frames,
                          lambda h, w: np.zeros((h, w, 3), np.float32))
    # kytpu's jitted triangle test drops hits (ROADMAP §3, "XLA CPU
    # rounding"): the torus is held against kytpu's code run eagerly
    with jax.disable_jit(cmd == "trimesh"):
        jcli.main(argv)
    got, n_got = _montage(monkeypatch, tcli, frames,
                          lambda h, w: torch.zeros((h, w, 3)))
    tcli.main([*argv, "--device", "cpu"])
    ref, got = np.asarray(ref[0]), torch.as_tensor(got[0]).numpy()
    assert len(n_got) == len(n_ref)
    assert got.shape == ref.shape == (*RUNS[cmd][1], 3)
    assert np.isclose(got, ref, rtol=1e-3, atol=1e-4).mean() > 0.999
    assert got.max() > 0


def test_subcommands_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["single", "--size", "4", "--spp", "1", "--out",
                   str(tmp_path / "x.bmp")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinv.main(["--size", "4", "--steps", "1"])


def _single_args(engine):
    return ["single", "--size", "10", "--spp", "2", "--depth", "2",
            "--seed", "7", "--engine", engine, "--device", "cpu"]


def _same_as_render(tmp_path, args, **render_kw):
    out = tmp_path / "cli.bmp"
    tcli.main([*args, "--out", str(out)])
    ref = tmp_path / "ref.bmp"
    tio.write_bmp(str(ref), render(tcli.single_scene(10), spp=2, seed=7,
                                   device="cpu", **render_kw))
    assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("engine", ["jnp", "pallas"])
def test_single_is_render(tmp_path, engine):
    cfg = PathConfig(max_depth=2, variant="iteration", strategy="both_mis")
    _same_as_render(tmp_path, _single_args(engine), cfg=cfg,
                    engine={"jnp": "jnp", "pallas": "cuda"}[engine])


@pytest.fixture()
def world_of_one(tmp_path):
    multihost.initialize(f"file://{tmp_path}/init", 1, 0, device="cpu")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("engine", ["jnp", "pallas"])
def test_mesh_1x1_is_render(tmp_path, world_of_one, engine):
    """On a 1x1 mesh `single` writes render()'s bytes: the jnp frame, and
    the kernel frame under the sharded sampler mapping ("random" runs as
    the decomposition-invariant "hash"), as in kytpu."""
    if engine == "jnp":
        kw = dict(cfg=PathConfig(max_depth=2, variant="iteration",
                                 strategy="both_mis"), engine="jnp")
    else:
        kw = dict(cfg=KernelConfig(max_depth=2, sampler="hash"),
                  engine="cuda")
    _same_as_render(tmp_path, _single_args(engine) + ["--mesh", "1,1"], **kw)


def _captured(monkeypatch, main, argv):
    """The namespace main(argv) parses, with its subcommand not run."""
    seen = []
    real = argparse.ArgumentParser.parse_args

    def parse(self, *a, **kw):
        ns = real(self, *a, **kw)
        seen.append(dict(vars(ns)))
        ns.fn = lambda args: None
        return ns

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return seen[-1]


def _help(capsys, main, argv):
    with pytest.raises(SystemExit):
        main([*argv, "--help"])
    text = capsys.readouterr().out
    return (set(re.findall(r"--[a-z][a-z-]*", text)),
            set(re.findall(r"\{[^}]*\}", text)))


def test_parsers_match_kytpu(monkeypatch, capsys):
    cmds = _help(capsys, jcli.main, [])[1]
    assert cmds == _help(capsys, tcli.main, [])[1]
    assert "{" + ",".join(tcli.COMMANDS) + "}" in cmds
    for cmd in tcli.COMMANDS:
        ref = _captured(monkeypatch, jcli.main, [cmd])
        got = _captured(monkeypatch, tcli.main, [cmd])
        for ns in (ref, got):
            ns.pop("fn")
        assert got.pop("device") == "cuda"
        assert got == ref, cmd
        flags_j, choices_j = _help(capsys, jcli.main, [cmd])
        flags_t, choices_t = _help(capsys, tcli.main, [cmd])
        assert flags_t == flags_j | {"--device"}, cmd
        assert choices_t == choices_j, cmd


def _first_step_loss(mode):
    """make_train_step(engine="jnp")'s first loss on the inverse demo's
    inputs at --size 8 --spp 1 --depth 1 --seed 0."""
    cfg = PathConfig(max_depth=1, strategy="both_mis")
    key = trng.key(0)
    if mode == "texture":
        true_img = tinv.demo_texture(16)
        scene = tb.cornell_box(width=8, height=8, back_image=true_img)
        scene_w = tb.cornell_box(width=8, height=8,
                                 back_image=np.full_like(true_img, 0.5))
        names = ("tex_image",)
    else:
        scene = tb.cornell_box(width=8, height=8)
        d = get_params(scene)["mat_diffuse"].numpy()
        rng = np.random.default_rng(0)
        wrong = torch.from_numpy(np.clip(d * rng.uniform(0.3, 1.6, d.shape),
                                         0, 1).astype(np.float32))
        scene_w = set_params(scene, {"mat_diffuse": wrong})
        names = ("mat_diffuse", "mat_specular")
    target = render_once(scene, key, spp=1, cfg=cfg, device="cpu").detach()
    step, _, _ = make_train_step(scene_w, target, spp=1, cfg=cfg,
                                 engine="jnp", names=names, device="cpu")
    return float(step(key))


@pytest.mark.parametrize("mode", ["albedo", "texture"])
def test_inverse_demo(mode, tmp_path, capsys):
    ck = tmp_path / "ck.npz"
    out = tinv.main(["--mode", mode, "--size", "8", "--spp", "1", "--steps",
                     "2", "--depth", "1", "--device", "cpu", "--checkpoint",
                     str(ck), "--checkpoint-every", "2"])
    text = capsys.readouterr().out
    loss0 = _first_step_loss(mode)
    assert out["losses"][0] == loss0
    assert f"step    0  loss {loss0:.6f}" in text
    assert "step    1  loss" in text and "mean abs error" in text
    assert all(np.isfinite(out["losses"]))
    like = (out["params"], out["optimizer"].state_dict())
    (params, state), step = load_checkpoint(str(ck), like)
    assert step == 2
    for n, v in out["params"].items():
        assert torch.equal(params[n], v.detach())
    assert set(state["state"]) == set(like[1]["state"])


@pytest.mark.parametrize("mode", ["albedo", "texture"])
def test_inverse_demo_matches_kytpu(mode, capsys):
    """The demo's first loss and its perturbation's error, as kytpu's
    prints them on the same arguments."""
    argv = ["--mode", mode, "--size", "8", "--spp", "1", "--steps", "1",
            "--depth", "1"]
    jinv.main(argv)
    ref = capsys.readouterr().out
    out = tinv.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    loss = float(re.search(r"step    0  loss (\S+)", ref).group(1))
    assert np.isclose(out["losses"][0], loss, rtol=1e-3, atol=1e-4)
    err0 = re.compile(r"mean abs error (\S+) ->")
    assert err0.search(got).group(1) == err0.search(ref).group(1)
