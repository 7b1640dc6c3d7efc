"""Elastic tile rendering: failure detection, re-dispatch, resume
(kytpu/dist/elastic.py).

The film is cut into tiles whose radiance is a pure function of (scene,
seed, tile pixels): a worker failure costs one tile's re-dispatch, and a
checkpoint written after every tile makes the render resumable across
process restarts. `render_elastic` is scheduled on the host: a worker is
any callable that renders a tile (this process's device, another host, a
pool). fault_rate and fault_rng inject failures for testing.
"""

from __future__ import annotations

import numpy as np

from kytpu_torch.integrator import path as kpath
from kytpu_torch.core.device import check_device
from kytpu_torch.integrator.render import render_region
from kytpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


class WorkerFailure(RuntimeError):
    pass


def tile_boxes(width: int, height: int, tile: int):
    """The static tile decomposition: a list of (x0, y0, x1, y1)."""
    boxes = []
    for y0 in range(0, height, tile):
        for x0 in range(0, width, tile):
            boxes.append((x0, y0, min(x0 + tile, width),
                          min(y0 + tile, height)))
    return boxes


def render_tile(scene, box, spp, seed, cfg) -> np.ndarray:
    """One tile through `render_region` on the scene's device, unclamped,
    as numpy (y1 - y0, x1 - x0, 3)."""
    x0, y0, x1, y1 = box
    return render_region(scene, x0, y0, x1, y1, spp=spp, seed=seed, cfg=cfg,
                         clamp=False, device=scene.device).cpu().numpy()


def render_elastic(scene, spp: int = 16, seed: int = 1234,
                   cfg: kpath.PathConfig | None = None, tile: int = 64,
                   checkpoint: str | None = None, max_retries: int = 3,
                   fault_rate: float = 0.0, fault_rng=None,
                   worker=render_tile, clamp: bool = True,
                   device="cuda") -> np.ndarray:
    """Render the film tile by tile with retry and checkpoint/resume ->
    numpy (H, W, 3); the scene renders on `device` (the card unless
    device="cpu").

    Each tile is retried up to max_retries times on any exception (a
    worker's or an injected one, fault_rate). With `checkpoint`, finished
    tiles persist, and a rerun resumes from the last checkpoint (kytpu's
    files too: the same layout). A tile's radiance depends only on (scene,
    seed, tile pixels), so the film does not depend on which attempt,
    process or host rendered a tile."""
    cfg = cfg or kpath.PathConfig()
    scene = scene.to(check_device(device))
    w, h = scene.camera.width, scene.camera.height
    boxes = tile_boxes(w, h, tile)
    film = np.zeros((h, w, 3), np.float32)
    done = np.zeros(len(boxes), bool)

    if checkpoint is not None:
        try:
            (film_c, done_c), _ = load_checkpoint(
                checkpoint, (film, done.astype(np.int32)))
            film = np.array(film_c, np.float32)
            done = np.array(done_c).astype(bool)
        except FileNotFoundError:
            pass

    fault_rng = fault_rng or np.random.default_rng(0)

    for i, box in enumerate(boxes):
        if done[i]:
            continue
        last_err = None
        for _ in range(max_retries + 1):
            try:
                if fault_rate > 0.0 and fault_rng.random() < fault_rate:
                    raise WorkerFailure(f"injected fault on tile {i}")
                out = worker(scene, box, spp, seed, cfg)
                break
            except Exception as e:  # noqa: BLE001: any worker's death
                last_err = e
                out = None
        if out is None:
            raise RuntimeError(
                f"tile {i} failed after {max_retries + 1} attempts"
            ) from last_err
        x0, y0, x1, y1 = box
        film[y0:y1, x0:x1] = out
        done[i] = True
        if checkpoint is not None:
            save_checkpoint(checkpoint, (film, done.astype(np.int32)),
                            step=int(done.sum()))

    if clamp:
        film = np.clip(film, 0.0, 1.0)
    return film
