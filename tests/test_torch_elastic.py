"""kytpu_torch.dist.elastic and kytpu_torch.utils.checkpoint, mirroring
tests/test_elastic.py and tests/test_utils.py, on the CPU; and the files
that kytpu's save_checkpoint writes load here, and this package's there.

Tolerances: the elastic film against the monolithic frame atol 1e-6
(kytpu's); a film with faults or resumed against one without, to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.utils import checkpoint as jck
from kytpu_torch.dist.elastic import (WorkerFailure, render_elastic,
                                      render_tile, tile_boxes)
from kytpu_torch.integrator.path import PathConfig
from kytpu_torch.integrator.render import render
from kytpu_torch.scene import builders
from kytpu_torch.utils.checkpoint import (CheckpointMismatchError,
                                          load_checkpoint, save_checkpoint)
import tests.torch_threads  # noqa: F401  (one torch thread a process)

CFG = PathConfig(max_depth=2)


@pytest.fixture(scope="module")
def scene():
    return builders.cornell_box(width=16, height=16)


def elastic(scene, **kw):
    return render_elastic(scene, spp=2, seed=9, cfg=CFG, tile=8,
                          device="cpu", **kw)


def test_tile_boxes_cover():
    boxes = tile_boxes(20, 12, 8)
    cover = np.zeros((12, 20), int)
    for x0, y0, x1, y1 in boxes:
        cover[y0:y1, x0:x1] += 1
    assert (cover == 1).all()


def test_elastic_matches_monolithic(scene):
    a = render(scene, spp=2, seed=9, cfg=CFG, engine="jnp",
               device="cpu").numpy()
    np.testing.assert_allclose(a, elastic(scene), atol=1e-6)


def test_elastic_survives_faults(scene):
    img = elastic(scene, fault_rate=0.4,
                  fault_rng=np.random.default_rng(3), max_retries=8)
    np.testing.assert_array_equal(img, elastic(scene))


def test_elastic_gives_up(scene):
    def dead_worker(*a, **k):
        raise WorkerFailure("always down")
    with pytest.raises(RuntimeError, match="failed after"):
        render_elastic(scene, spp=1, seed=9, cfg=CFG, tile=16,
                       worker=dead_worker, max_retries=1, device="cpu")


def test_elastic_resume(scene, tmp_path):
    ck = str(tmp_path / "film.npz")
    calls = []

    def dying(sc, box, spp, seed, cfg):
        calls.append(box)
        if len(calls) >= 3:
            raise WorkerFailure("preempted")
        return render_tile(sc, box, spp, seed, cfg)

    with pytest.raises(RuntimeError):
        elastic(scene, checkpoint=ck, worker=dying, max_retries=0)
    resumed = []

    def resuming(sc, box, spp, seed, cfg):
        resumed.append(box)
        return render_tile(sc, box, spp, seed, cfg)

    img = elastic(scene, checkpoint=ck, worker=resuming)
    np.testing.assert_array_equal(img, elastic(scene))
    assert len(resumed) == len(tile_boxes(16, 16, 8)) - 2


def test_elastic_defaults_to_the_card(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        render_elastic(scene, spp=1, tile=16)


def test_checkpoint_roundtrip(tmp_path):
    state = {"film": torch.arange(12.0).reshape(2, 2, 3),
             "params": {"a": torch.ones(3), "b": np.zeros((2, 2))},
             "n": 3.5}
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, state, step=7)
    back, step = load_checkpoint(p, state)
    assert step == 7
    assert isinstance(back["film"], torch.Tensor)
    assert torch.equal(back["film"], state["film"])
    assert isinstance(back["params"]["b"], np.ndarray)
    np.testing.assert_array_equal(back["params"]["b"], state["params"]["b"])
    assert float(back["n"]) == 3.5


def test_checkpoint_optimizer_state(tmp_path):
    w = torch.ones((4, 3), requires_grad=True)
    opt = torch.optim.Adam([w], lr=1e-2)
    w.grad = torch.full_like(w, 0.5)
    opt.step()
    st = opt.state_dict()["state"][0]
    tree = ({"w": w}, {"exp_avg": st["exp_avg"],
                       "exp_avg_sq": st["exp_avg_sq"]})
    p = str(tmp_path / "opt.npz")
    save_checkpoint(p, tree)
    (params2, st2), _ = load_checkpoint(p, tree)
    assert torch.equal(params2["w"], w.detach())
    assert torch.equal(st2["exp_avg_sq"], st["exp_avg_sq"])


def test_checkpoint_structure_mismatch(tmp_path):
    p = str(tmp_path / "x.npz")
    save_checkpoint(p, {"a": torch.ones(2)})
    with pytest.raises(CheckpointMismatchError):
        load_checkpoint(p, {"a": torch.ones(2), "b": torch.ones(2)})
    with pytest.raises(CheckpointMismatchError, match="shape"):
        load_checkpoint(p, {"a": torch.ones(3)})
    with pytest.raises(CheckpointMismatchError, match="treedef"):
        load_checkpoint(p, (torch.ones(2),))
    # the structure check can be waived
    back, _ = load_checkpoint(p, (torch.ones(2),), strict=False)
    assert torch.equal(back[0], torch.ones(2))
    save_checkpoint(p, {"a": np.float32(1.0)})
    with pytest.raises(CheckpointMismatchError, match="shape"):
        load_checkpoint(p, {"a": torch.ones(2)})


TREES = [
    {"b": np.arange(3.0), "a": (np.ones(1), [np.zeros(2), None])},
    (np.ones(2), np.zeros(3)),
    (np.ones(2),),
    [np.float32(1.5), {"x": np.arange(4)}],
    np.arange(5),
]


@pytest.mark.parametrize("tree", TREES)
def test_checkpoint_files_cross_packages(tmp_path, tree):
    """kytpu's file loads here (strict: the same structure notation) and
    this package's loads in kytpu."""
    pk, pt = str(tmp_path / "k.npz"), str(tmp_path / "t.npz")
    jck.save_checkpoint(pk, jax.tree.map(jnp.asarray, tree), step=4)
    save_checkpoint(pt, tree, step=5)
    back, step = load_checkpoint(pk, tree)
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back, step = jck.load_checkpoint(pt, jax.tree.map(jnp.asarray, tree))
    assert step == 5
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
