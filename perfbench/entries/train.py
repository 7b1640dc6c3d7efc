"""Entry "train": the port's inverse-rendering step,
`kytpu_torch.diff.inverse.make_train_step(engine="cuda")`, on the mix's
spp and depth, relmse against a target the reference renders at set-up.

Set-up builds one step (model tables, Adam state) from the seed: the
trainable tables start as the configuration's scaled by factors drawn from
the seed, and the first three steps, keyed as every step of the window is
(`oracle.step_key`), go through the step itself. Their losses, the first
gradient (Adam's first moment after step 1 over 1 - beta1) and the
parameters' change are what the reference is compared with; the window
goes on with the same step from step 4.
"""

from __future__ import annotations

import torch

from perfbench import compare
from perfbench.counts import transport
from perfbench.reference import oracle

CHECKED_STEPS = 3


class Workload:
    entry = "train"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from kytpu_torch.diff.inverse import make_train_step
        from kytpu_torch.diff.params import set_params
        from kytpu_torch.scene import builders as program_scenes

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        ref_scene = oracle.build_scene(config, self.device)
        self.cfg = oracle.kernel_config(config, traffic)
        self.params0 = oracle.perturbed(ref_scene, seed, traffic["perturb"])
        # the benchmark's own input, made before the program's set-up and
        # left out of its memory peak
        self.target = oracle.render_frame(
            ref_scene, self.cfg, traffic["target_spp"],
            oracle.frame_seed(seed, 0xFFFFFFFF), 1 << 20, clamp=False)
        del ref_scene
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cam = config["args"]
        self.lanes = cam["width"] * cam["height"] * traffic["spp"]
        n = self.target.numel()
        m = sum(p.numel() for p in self.params0.values())
        # read once: the target and the tables; written once: the tables
        # and the loss
        self.io_bytes = 4 * (n + 2 * m + 1)

        scene = getattr(program_scenes, config["scene"])(**config["args"])
        scene = set_params(scene, {k: v.clone() for k, v in
                                   self.params0.items()})
        self.step, self.params, self.opt = make_train_step(
            scene, self.target.clone(), spp=traffic["spp"],
            max_depth=traffic["max_depth"], engine="cuda",
            names=tuple(traffic["names"]),
            kernel_sampler=config["transport"]["sampler"], device=device)
        self.keys = oracle.step_key(seed, torch.arange(1 << 16)).cpu()
        before = {k: v.detach().clone() for k, v in self.params.items()}
        beta1 = self.opt.param_groups[0]["betas"][0]
        self.losses, self.grads = [], None
        for i in range(CHECKED_STEPS):
            self.losses.append(float(self.step(self.keys[i])))
            if i == 0:
                # Adam's first moment after one step is (1 - beta1) g; none
                # where the step left the optimizer as it was
                self.grads = {k: self.opt.state[v]["exp_avg"].detach().clone()
                              / (1 - beta1) if "exp_avg" in self.opt.state[v]
                              else torch.zeros_like(v)
                              for k, v in self.params.items()}
        self.change = {k: self.params[k].detach().clone() - before[k]
                       for k in self.params}
        self.next = CHECKED_STEPS

    def call(self):
        """Start one step: returns the loss as the step returns it."""
        i = self.next
        self.next += 1
        return self.step(self.keys[i % len(self.keys)])

    @staticmethod
    def result(loss):
        """The loss on the host, as `recover` reads it."""
        return float(loss)

    def free(self) -> None:
        del self.step, self.params, self.opt

    def check(self, limits: dict):
        """-> (numbers, failed, work): the first steps against the
        reference's, and the least work of a step from its tally."""
        ref_scene = oracle.build_scene(self.config, self.device)
        tally = transport.Tally()
        losses, grads, params = oracle.train_steps(
            ref_scene, self.cfg, self.target, self.params0,
            self.keys[:CHECKED_STEPS], self.traffic["spp"],
            self.traffic["lr"], tally)
        ref = {"losses": losses, "grads": grads,
               "change": {k: params[k] - self.params0[k].to(params[k].device)
                          for k in params}}
        prog = {"losses": self.losses, "grads": self.grads,
                "change": self.change}
        numbers = compare.train_numbers(prog, ref)
        failed = int(any(numbers[k] > limits[k] for k in numbers))
        per = tally.scaled(1.0 / CHECKED_STEPS)
        static = oracle.diff_tables(ref_scene, self.cfg, params).static
        ops = (transport.k1_ops(static, self.cfg, per)
               + transport.k3_ops(static, self.cfg, per))
        return numbers, failed, {"fp32_ops": ops, "bytes": self.io_bytes}
