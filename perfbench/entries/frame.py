"""Entry "frame": the port's `kytpu_torch.integrator.render.render(engine=
"cuda")` of the configuration's scene at the mix's spp and depth, the
(H, W, 3) image brought to the host as `cli/render.py` writes it.

Frame i of a run renders with `oracle.frame_seed(seed, i)`; frames 0 and 1
warm up, the window starts at frame 2. Once the window has closed, frames
drawn from the seed are rendered again by the reference and compared pixel
by pixel.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from perfbench import compare
from perfbench.counts import transport
from perfbench.reference import oracle

WARM_FRAMES = 2
RAYS_PER_PASS = 1 << 20   # render()'s default


class Workload:
    entry = "frame"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from kytpu_torch.integrator.render import render
        from kytpu_torch.kernels.wavefront import KernelConfig
        from kytpu_torch.scene import builders as program_scenes

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cam = config["args"]
        self.lanes = cam["width"] * cam["height"] * traffic["spp"]
        self.io_bytes = 4 * 3 * cam["width"] * cam["height"]
        self.seeds = [int(s) >> 2 for s in oracle.krng.bits(
            oracle.krng.fold_in(oracle.root_key(seed),
                                torch.arange(1 << 16)), 1)[:, 0]]
        scene = getattr(program_scenes, config["scene"])(
            **config["args"]).to(device)
        kcfg = KernelConfig(max_depth=traffic["max_depth"],
                            **config["transport"])

        def frame(i):
            return render(scene, spp=traffic["spp"], seed=self.seeds[i],
                          cfg=kcfg, clamp=traffic["clamp"],
                          rays_per_pass=RAYS_PER_PASS, engine="cuda",
                          device=device)

        self.frame = frame
        self.images = {}
        for i in range(WARM_FRAMES):
            self.result((i, frame(i)))
        self.images.clear()
        self.next = WARM_FRAMES

    def call(self):
        """Start one frame: returns (its index, the image on the device)."""
        i = self.next
        self.next += 1
        return i, self.frame(i % len(self.seeds))

    def result(self, handle) -> np.ndarray:
        i, img = handle
        host = img.cpu().numpy()
        self.images[i] = host
        return host

    def free(self) -> None:
        del self.frame

    def check(self, limits: dict):
        """-> (numbers, failed, work): frames drawn from the seed against
        the reference's, and the least work of a frame from its tally."""
        ref_scene = oracle.build_scene(self.config, self.device)
        cfg = oracle.kernel_config(self.config, self.traffic)
        picks = sorted(random.Random(self.seed).sample(
            sorted(self.images), min(self.traffic["check_calls"],
                                     len(self.images))))
        tally = transport.Tally()
        shares = []
        for i in picks:
            ref = oracle.render_frame(
                ref_scene, cfg, self.traffic["spp"],
                self.seeds[i % len(self.seeds)], RAYS_PER_PASS,
                clamp=self.traffic["clamp"], tally=tally)
            shares.append(compare.pixel_gap_share(self.images[i],
                                                  ref.cpu().numpy()))
        numbers = {"pixel_gap_share": max(shares)}
        failed = sum(s > limits["pixel_gap_share"] for s in shares)
        per = tally.scaled(1.0 / max(len(picks), 1))
        static = oracle.wf.pack_tables(ref_scene, cfg).static
        return numbers, failed, {
            "fp32_ops": transport.k1_ops(static, cfg, per),
            "bytes": self.io_bytes}
