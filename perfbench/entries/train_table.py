"""Entry "train_table": the port's inverse-rendering step past 64 surfaces,
`kytpu_torch.diff.inverse.make_train_step(engine="cuda")`, whose loss runs
the table kernels (K6 forward, K7 backward with the sort of its row tags
and its sums by row) on the mix's spp and depth, relmse against a target
the reference (reference/tables.py) renders at set-up. Its `entry` is
"train", so train_rays_per_s and the other train readers read it.

Set-up builds the program's scene first (a checkout without the
configuration's builder stops there), then the reference's target, then
one step (model tables, Adam state) from the seed: the trained tables
start as the configuration's scaled by factors drawn from the seed, and
the first three steps, keyed as every step of the window is
(`oracle.step_key`), go through the step itself. On the card the step must
have launched K6 and K7 and neither K2 nor K3 by then. Their losses, the
first gradient (Adam's first moment after step 1 over 1 - beta1) and the
parameters' change are what the reference is compared with; the window
goes on with the same step from step 4.
"""

from __future__ import annotations

import torch

from perfbench import compare
from perfbench.counts import tables as counts
from perfbench.reference import oracle
from perfbench.reference import tables as ref

CHECKED_STEPS = 3


class Workload:
    entry = "train"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from kytpu_torch.diff.inverse import make_train_step
        from kytpu_torch.diff.params import set_params
        from kytpu_torch.scene import builders as program_scenes
        from kytpu_torch.utils import profiling as kprof

        scene = getattr(program_scenes, config["scene"])(**config["args"])
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        ref_scene = ref.build_scene(config, self.device)
        self.cfg = oracle.kernel_config(config, traffic)
        self.params0 = ref.perturbed(ref_scene, seed, traffic["perturb"])
        # the benchmark's own input, made before the program's set-up and
        # left out of its memory peak
        self.target = ref.render_frame(
            ref_scene, self.cfg, traffic["target_spp"],
            oracle.frame_seed(seed, 0xFFFFFFFF), 1 << 20, clamp=False)
        del ref_scene
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cam = config["args"]
        self.lanes = cam["width"] * cam["height"] * traffic["spp"]

        scene = set_params(scene, {k: v.clone() for k, v in
                                   self.params0.items()})
        kprof.reset("k2", "k3", "k6", "k7")
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
        if self.device.type == "cuda":
            got = {k: kprof.launches(k) for k in ("k2", "k3", "k6", "k7")}
            if not (got["k6"] and got["k7"]) or got["k2"] or got["k3"]:
                raise RuntimeError(f"the step is not on the table kernels: "
                                   f"launches {got}")

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
        ref_scene = ref.build_scene(self.config, self.device)
        extracted = ref.bs.extract_tables(ref_scene)
        tally = counts.TableTally()
        losses, grads, params = ref.train_steps(
            ref_scene, self.cfg, self.target, self.params0,
            self.keys[:CHECKED_STEPS], self.traffic["spp"],
            self.traffic["lr"], tally, extracted)
        ref_out = {"losses": losses, "grads": grads,
                   "change": {k: params[k] - self.params0[k].to(
                       params[k].device) for k in params}}
        prog = {"losses": self.losses, "grads": self.grads,
                "change": self.change}
        numbers = compare.train_numbers(prog, ref_out)
        failed = int(any(numbers[k] > limits[k] for k in numbers))
        per = tally.scaled(1.0 / CHECKED_STEPS)
        static = extracted[0]
        return numbers, failed, {
            "fwd_ops": counts.fwd_ops(static, self.cfg, per),
            "fwd_bytes": counts.fwd_bytes(self.cfg, per),
            "bwd_bytes": counts.bwd_bytes(static, self.cfg, per)}
