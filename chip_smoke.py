"""Smoke run of kytpu_torch on one NVIDIA GPU: build, check, render, train,
time.

    python3 chip_smoke.py            # a few minutes on an H100

Phases, one line each (a few for phase 3):
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: compiles each kytpu_torch/kernels/csrc/*.cu with its own nvcc,
     all started together, and prints each source's nvcc time and what
     -Xptxas -v said of each kernel, then K1's to K4's registers, stack and
     spills, instantiation by instantiation;
  3. kernels vs plain, on 256K camera rays at depth 5, for Veach MIS and two
     Cornell boxes, across the three samplers, both NEE modes, both shadow
     modes and both exponent modes (a trainable-exponent case on Veach's
     four Phong planks), with the scene's tables staged in shared memory
     and, on a Veach and a Cornell case, read from device memory
     (kernels/wavefront.py STAGE_BUDGET 0 forces that route): the forward
     megakernel K1 against its plain PyTorch version (bit for bit; and
     the tolerance the other kernels are held to: at most 0.5% of lanes
     outside rtol=1e-3/atol=1e-4 per channel, and the means within 3
     standard errors); the residual forward K2's radiance against K1's (bit
     for bit), its radiance and its cache against the plain K2 (bit for
     bit, and plane by plane: each plane at most 0.5% of lanes outside
     rtol=1e-3/atol=1e-4; the int planes: at most 0.5% of lanes differ);
     the coefficient-cache backward K3 on a seeded upstream
     gradient against the plain K3 (each table within rtol=1e-4 plus 1e-6
     of its largest entry) and against itself (bit for bit, two launches);
     the path-replay backward K4 on the same lanes and gradient against the
     plain K4 (the same bound), against itself (bit for bit) and against
     K3 (rtol=2e-3 plus 2e-5 of the table's largest entry, the reference's
     bound for this cross-check); in the exponent case K2's "Bk"/"tuk"
     planes and K3's and K4's dexp are among the checked. K3 and K4 run
     there on every accumulator route (kernels/wavefront.py acc_route: a
     column of a shared block, a row in local memory, which ACC_BUDGET 0
     forces, and the shared block's layout in device memory, which a
     local row of no room forces), each against its
     plain version and itself as above, and the routes against each
     other bit for bit; K4 in 32-lane chunks (no refill) at these 262K
     lanes. Then K2, K3 and K4 on a 32-light scene (tests/test_torch_cuda.py
     many_lights, 199 kept columns: past ACC_BUDGET, so the local route),
     against their plain versions and each other as above; then the
     camera-rays kernel (csrc/camera_rays.cu, kernels/camera.py) against its
     plain chain on Veach's camera, bit for bit, under "random" and "hash"
     (sample base 6) at the train step's 10,092,544 lanes, a frame pass's
     946,176 and 946,253 (not a multiple of the block), one launch each, and
     both timed under "random" at the first two counts;
  4. frames: render(veach_mis(512, 308)) and render(cornell_box 256x256) at
     64 spp through render(engine="cuda"), the main path, whose launches are
     counted (the rays kernel once a pass, none under "sobol"), and the
     Veach frame again with cfg sampler="sobol"; each
     64-spp frame and a 4-spp frame of each default-sampler scene against
     the same frame traced by the plain version (same seed and pass split,
     so the same lanes: 946176 a pass for Veach, 1048576 for Cornell); then one
     warmed frame of each under torch.profiler: the device's busy time, the
     kernel's share of it, and the device's idle share of the median wall
     time of 5 unprofiled warmed frames;
  5. timing: Veach forward at 4M lanes, depth 5, CUDA events, kernel and
     plain, and the two outputs compared (bit for bit);
  6. forward+backward: bench.py's workload (Veach 512x308, depth 5, 4M
     lanes, loss = out.sum() / N) through make_cuda_diff_tracer: its time
     and peak memory, then K2, K3 and K1 alone under CUDA events, the plain
     K2 and K3, and the kernels against them on those 4M lanes (bounds of
     phase 3; K2 and its cache bit for bit), and each kernel's bound
     (`bounds`; `k1_ops` counts the shadow sweeps the data surely needs);
     K1 and K2 again with the tables read from device memory (timed, bit
     for bit the staged route's); the SIMT share of K1 and K2 on those
     lanes from K2's cache (`simt_share`), one lane a thread against
     dead-lane refill; then the same workload
     through make_cuda_diff_tracer(backward="replay"), the replay path,
     whose launches are counted: its time and peak memory, K4 alone (its
     refilled chunk printed), the plain K4, the tracer's gradient against
     K4's (bit for bit), K4 against the plain K4 and against K3 on those
     lanes; K3 and K4 on every accumulator route, timed and held to each
     other bit for bit; and K3 and K4 on the row-tagged route forced
     (kernels/wavefront.py DENSE_MAX_ROWS 0), timed beside the dense ones
     and held to them (bounds of phase 3);
  7. training, the second main path: five make_train_step(engine="cuda")
     steps on the Cornell box at its published 256x256, 4 spp, depth 3,
     kernel_sampler="hash", from the true scene with its diffuse table
     scaled by 0.4, against the true scene rendered at 64 spp: launches
     counted (the rays kernel once a step), ms per step, one step profiled. All five steps take one key,
     so each lowers the same estimator: the loss must fall at every step
     and the diffuse table must move towards the truth (with a new key a
     step, the loss also carries each key's Monte Carlo noise, which on
     small frames outweighs a few steps' gain). A sixth step records what
     its diff tracer gave K2 and K3 (tables, lanes, seed, the upstream
     gradient of relmse): K2's radiance against K1's on those lanes (bit
     for bit), K2 and its cache against the plain K2, K3 against the plain
     K3 on the step's own gradient (bounds of phase 3), and K3 against
     itself (bit for bit);
  8. glossiness training: five make_train_step steps on veach_mis(512, 308)
     at 4 spp, depth 3, kernel_sampler="sobol", names=TRAINABLE +
     ("mat_exponent",) with the exponent in softplus space, from the true
     scene with its plank exponents halved, against the true scene
     rendered at 64 spp: launches counted, ms per step, one step profiled,
     one key; the loss must fall from step 1 to step 5 and so must the mean
     |log e - log e_true| over the plank rows; a sixth step's own K2 and K3
     calls against their plain versions, as in phase 7;
  9. big scenes, past 64 surfaces, on the table-driven kernels of
     kernels/bigscene.py: random_spheres(n=1024) (1,026 surfaces) and
     mesh_scene(icosphere(3)) (1,282) at 256x256.
     a. K5, K6, K7 and the path-replay backward K8 against their plain
        versions on 64K camera rays at depth 3 of each scene, under each
        sampler, both shadow modes and both exponent modes (the bounds of
        phase 3); K6's radiance against K5's, K7 and K8 against themselves,
        bit for bit; K8 against K7 (the bound of K4 against K3); K5, K6 and
        K8 under the default cull against the same build with cull="off",
        bit for bit (`same_as_cull_off`);
     b. K5 against K1 on the Cornell box (256K lanes, depth 5): the share
        of lanes within 1e-3 (at least 99.5%; K5 reads each hit's Phong
        exponent from its row, K1 folds the scene's one exponent into
        constants), and a 16-spp frame through render(engine="bigscene");
     c. 16-spp frames of both scenes at depth 3 through render(), the main
        path (render routes past 64 surfaces to K5; launches counted, K1-K4
        must stay at 0), each against the same frame through the plain K5,
        then 5 warmed frames and one profiled: busy time, K5's share, idle
        share;
     d. benchmarks/run.py's K5 workload (spheres, 1M pixel-centre lanes,
        depth 3): K5, K6, K7 and K8 under CUDA events, the plain versions
        once each and the kernels against them, forward+backward through
        make_bigscene_diff_tracer (time, peak memory, its gradient K7's bit
        for bit) and through make_bigscene_diff_tracer(backward="replay"),
        the replay path, whose launches are counted (K5 and K8: time, peak
        memory, its gradient K8's bit for bit), and the bounds of K5, K6, K7
        and K8; K5, K6 and K8 with cull="off" timed and held to the culled
        launches bit for bit; the culled bound (`swept_counts`: the work of
        each sweep culled by the lane's own tree walk, replayed on the
        plain K6's rays) beside the full-sweep one (`k5_ops`, `k8_ops`),
        and the walk's rows and node steps of the warp a lane-sweep; the
        mesh's K5 at its 1M pixel-centre lanes, culled and not, with its
        culled bound;
        the sums by tag (csrc/tag_sums.cu) on the row tags and planes K7 and
        K8 write there (`recorded_tag_sets`, `check_tag_sums`): the card's
        int32 radix sort against torch.sort(stable=True), perm and starts
        to the last index, the split segment sums against
        segment_sums_plain and themselves bit for bit, both timed beside
        their plain versions, one torch.sort and their bounds; K7's and
        K8's device time by kernel;
     e. training past 64 surfaces, the third main path: five
        make_train_step steps on the spheres at 256x256, 4 spp, depth 3,
        hash, from the true scene with the spheres' diffuse colours scaled
        by 0.4, one key, against the true scene at 64 spp: launches counted
        (K6 and K7, and K1-K4 at 0), the loss falling at every step, ms per
        step, one step profiled, and a sixth step's own K6 and K7 calls
        against their plain versions, as in phase 7.
 10. textures through K1-K4 (kytpu's checker floor and back-wall images):
     a. the textured K1, K2, K3 and K4 against their plain versions on 64K
        camera rays at depth 5 of 256x256 Cornell boxes with a checker
        floor, an 8x8 back-wall atlas (kytpu's select-chain route) and a
        16x16 one (its separable route), across samplers, NEE and shadow
        modes and both exponent modes (the bounds of phase 3; K1 and K2
        against their plain versions, K2 against K1, K3 and K4 against
        themselves, bit for bit; K4 against K3);
     b. kytpu's textured render (cli/render.py textured: Cornell 512x512,
        a checker floor and a 32x32 painted back wall) at 64 spp through
        render(), the main path, launches counted; a 4-spp frame against
        the plain K1, 5 warmed frames and one profiled;
     c. texture recovery, a main path: five make_train_step(names=
        ("tex_image",)) steps on Cornell 256x256 with a 16x16 back wall,
        from a flat 0.5 grey, 4 spp, depth 3, hash, one key, against the
        true scene at 64 spp: launches counted (K2, K3), the loss and the
        mean |texel - truth| falling, ms per step, one step profiled, a
        sixth step's own K2 and K3 against their plain versions;
     d. five checker-colour steps (names=("tex_color_a", "tex_color_b"),
        from 0.4 of the true colours): the loss falling, as in c;
     e. the textured replay path: make_cuda_diff_tracer(backward=
        "replay") on 1M lanes of the 16x16 scene, launches counted (K1,
        K4), its gradient (texels included) K4's bit for bit, K4's time.
 11. past 64 surfaces on every route kytpu takes: random_spheres(1024)'s
     spheres, light and sky with a textured ground, a 16x16-cell checker
     or an 8x8 atlas (the table kernels take them: K5-K8 with textures) or
     a 16x16 atlas (a separable one, which the tables refuse: K1-K4).
     a. the textured K5, K6, K7 and K8 against their plain versions on 64K
        camera rays at depth 3, under each sampler, both shadow modes and
        both exponent modes (the bounds of phase 3; K6 against K5, K7 and
        K8 against themselves bit for bit, K8 against K7, the texture
        adjoints live; K5, K6 and K8 against cull="off" bit for bit, and
        the pass rates of the blocks as in 9a); the
        textured K5 against K1 on a Cornell box with a
        checker floor and an 8x8 back wall (as 9b);
     b. a 16-spp frame of the checker scene through render(), the main
        path: launches counted (K5 only), against the plain K5's frame,
        then 5 warmed frames and one profiled;
     c. five checker-colour steps (names=("tex_color_a", "tex_color_b"),
        from 0.4 of the true colours) on it: launches counted (K6, K7), the
        loss falling, a sixth step's own K6 and K7 against their plain
        versions;
     d. on the 16x16-atlas scene, K1-K4: a 16-spp frame through render()
        (launches counted, K5 at 0; its cold and warm walls), five texel
        steps (K2, K3), a sixth step's own K2 and K3 against their plain
        versions; K1, K2 and K4 on their culled sweeps (past
        REFILL_MAX_ROWS surfaces: the tables in device memory, blocks of
        rows culled at the warp) against cull="off" bit for bit
        (`same_as_cull_off_wf`), K1 and K2 against their plain versions
        bit for bit, the row-tagged K3 and K4 against their plain versions
        and each other on 64K lanes, and on the untextured twin against K7
        (d_emission on the emissive rows), rows above 255 live; K1-K4
        timed at the 1M pixel-centre lanes, K1, K2 and K4 culled and with
        cull="off" in turn (the same bits), with their culled and
        full-sweep bounds and the blocks' pass rates (`wf_cull_counts`),
        the plain K1, K3 and K4 once,
        the row-tagged K3 on its shared and its local accumulator route
        (the same bits, both timed) and by device kernel, the sums by tag
        of K3's and K4's rows and texels as in 9d, and the replay path (K1
        + K4) through make_cuda_diff_tracer, its launches counted; then the textured K5, K7 and K8 at the checker
        scene's 1M lanes, the plain K5 and K8 once, and the textured replay
        path (K5 + K8), its launches counted; K5, K6 and K8 there against
        cull="off" bit for bit, the culled and full-sweep bounds and the
        blocks' pass rates;
     e. a smallpt frame through render() (K1), launches counted, and K1
        and K2 against their plain versions bit for bit on 64K lanes.
  12. the jnp engines (integrator/path.py, integrator/fast.py: torch code,
     no kernel of their own; `jnp_engines`) and their autograd train step,
     at full width:
     a. kytpu's README example, Cornell 256x256, PathConfig(strategy=
        "both_mis"), depth 5, at 16 of its 64 spp through
        render(engine="jnp"): the first and the median of 3 warmed walls,
        one profiled frame's device busy time, kernel count and idle share,
        the peak memory;
     b. the fast engine against K1 (render(engine="cuda")), Cornell 256x256
        at 64 spp each, clamped: the mean |difference| of the two frames
        downsampled to 4x4 must be under kytpu's 0.03
        (tests/test_kernel.py:175-188);
     c. the card against the CPU: trace_lanes on a 32x32 Veach region, 2
        spp, path both_mis, depth 3, lane by lane, and render_region's
        pixels, each held to the bounds of phase 3;
     d. rates: Veach 512x308 fast at 16 spp, the AOV normal frame at 4 spp
        (benchmarks/run.py:185-190) and random_spheres(1024) fast at 1M
        lanes, depth 3 (:99-131), with their peak memory;
     e. five make_train_step(engine="jnp") steps on Cornell 64x64, 4 spp,
        depth 3, against render_once's 2-spp target (key 7,
        benchmarks/run.py:192-207): ms a step, one step profiled, the loss
        and the parameters finite.
  13. past the caps and distribution:
     a. past 32 lights and 64 textures (`past_the_caps`): K1-K4 on
        many_lights (its copy here) with 32, 33 and 64 lights (34 and 65
        surfaces at 33 and 64: the dense and the row-tagged backwards) at
        512x512, 1M jittered lanes, depth 3, under hash/all/robust (timed)
        and random/single/parity, against their plain versions with the
        bounds of phase 3 (K1 and K2 with their cache bit for bit, K3 and
        K4 repeating bit for bit, K4 against K3); K5-K8 the same way past
        64 surfaces with 32, 33 and 64 lights (K7's and K8's rows past 32
        lights in device memory) and against cull="off" bit for bit; a
        scene of 65 checker textures and 33 lights (100 surfaces) through
        K5-K8 and K1-K4 (the row-tagged K3 and K4 on their device-memory
        route); then the main paths past the caps, launches counted: 16-spp
        frames through render() at 33 lights (K1) and 64 (K5), three train
        steps on each (K2/K3, K6/K7) and three checker-colour steps on the
        65-texture scene (K6/K7); each kernel's ms at 32, 33 and 64 lights;
     b. distribution (`distribution`): on a world-size-1 NCCL group, a 1x1
        mesh: render_sharded_pallas of Veach 512x308 at 64 spp (K1, 8
        samples a pass) and of random_spheres(1024) 256x256 at 16 spp
        (K5), each render()'s frame bit for bit, launches counted, their
        walls beside render()'s and the collectives' share of a frame
        (`collective_clock`); five sharded Cornell 256x256 kernel steps (4
        spp, depth 3, hash; K2/K3 counted) and five jnp steps at 64x64, the
        unsharded steps bit for bit; then two gloo ranks spawned on
        cuda:0 (NCCL refuses two ranks of one communicator on one card),
        meshes (2, 1) and (1, 2): the Veach frame within 2e-5 of the
        one-rank frame, one kernel step within rtol 1e-5 (loss) and atol
        1e-5 (parameters) of the unsharded step, each rank's wall and
        collectives' share.
  14. the entry points users start from (`entry_points`):
     a. the render CLI (kytpu_torch/cli/render.py) in-process at each
        subcommand's default size: single with --engine pallas (K1) and jnp,
        trimesh with --engine pallas (K5 on the 2,304-face torus) and jnp
        (at 6 of its 24 spp),
        spheres, mis, debug, textured, integrators, strategies and scenes,
        the main path, K1's and K5's launches counted: each run's wall,
        the file it wrote and validate_radiance of its image; single's
        pallas image against render(engine="cuda") bit for bit; K1 and
        K5 against their plain versions on the last pass each pallas run
        gave them (its tables, lanes and seeds), their errors in the
        kernels' line;
     b. the inverse CLI at its defaults (32x32, 4 spp, 60 steps, depth
        3), albedo and texture modes: ms a step, the losses at steps 0
        and 59 and the errors it prints;
     c. the grid (scene/accel.py) against the sweep on
        random_spheres(1024), 1M pixel-centre and 1M random rays: closest
        and any hits by tests/test_torch_accel.py's rule (the pixel-centre
        any-hit rays start where they enter the grid's box, so that at
        tmax 0.5 and 3 they traverse it), Mrays/s of each with the DDA's
        step count, and a 256x256 fast-mode frame through each (atol 1e-4
        on more than 99.9% of values);
     d. the native encoder built into a temporary directory, its BMP and
        HDR of the single frame against numpy's bytes, and the time of
        each: write_image's HDR through the encoder and through numpy, and
        BMP through numpy (write_image's only BMP route) and the encoder's
        own write_bmp.
  15. the last entry points (`last_entry_points`):
     a. `python -m kytpu_torch.bench` in a process of its own, as a user
        runs it: exactly one JSON line of kytpu's four keys, the metric
        [cuda_residual], a value > 0 and within 0.8-1.25x of 4,194,304 /
        phase 6's residual fwd+bwd ms, printed beside it;
     b. bench.main() in-process, the main path: K2 and K3 launched once a
        fwd+bwd (73 each), K1 and K4 not at all;
     c. bench's replay rate (K1 + K4, 73 launches each, counted) and the
        jnp fast engine's (torch autograd, no kernel; at 1M lanes), with
        the jnp run's peak memory;
     d. examples/nanopt at 256x256, 16 spp on the card, and at 64x64, 4 spp
        on the card against the CPU: the means within 1e-3, 99% of pixels
        within 2e-2;
     e. the parity tools without the reference binary: render_kytpu at
        1024x1024, 4 spp, seeds 1234 and 977 (the jnp path engine), their
        walls and compare_reference's noise floor between them.
  16. SPD's sphereflake (`sphereflake`; builders.spd_balls, 7,382
     surfaces, 512x512, 4 spp, depth 5, the benchmark's
     spd_balls.table_train4 step), run alone by `python3 chip_smoke.py
     sphereflake`: three make_train_step(engine="cuda") steps, K6 and K7
     launched and K2 and K3 not; the step's own K6 and K7 on its first 64K
     lanes against their plain versions (the bounds of phase 3, and
     whether bit for bit), K6 culled against cull="off" bit for bit, K6's
     counters (kernel.k6.rows, .sweeps, .bounds, .rows.tri, .bounds.tri,
     read in a profiled launch) equal to `swept_counts`, the kernel's tree
     walk worked out from the plain K6's rays, printed first; K6 and K7
     timed at the step's 1,048,576 lanes.
  17. SPD's tetrahedral pyramid (`tetra`; builders.spd_tetra at factors 4
     and 6: 256 and 4,096 matte triangles and a floor, 512x512, the
     benchmark's spd_tetra.tri_train4 step), run alone by `python3
     chip_smoke.py tetra`: phase 16's checks at each factor, the
     counters' tri class share equal to the replay's.
The line before the last is the kernels' JSON record (K1-K8, the tag
sort, the segment sums and the camera rays, whose launches are phases 4's
and 7's; each main path that sums by tag must launch
both; the segment sums' library time is one index_add_ of the same
entries by tag, and phase 9d also times segment_reduce of the sorted
ones), the one before it nvidia-smi's name and power limit, and the last
line is
{"ok": true, "device": {...}}. Any failed check raises: no result is printed
and the exit code is not 0, and the last line on standard error repeats the
last line printed before the failure, so the tail of standard error alone
says which check was running. It needs a CUDA device and imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from kytpu_torch.utils import profiling as kprof

RTOL, ATOL, MAX_BAD_SHARE = 1e-3, 1e-4, 0.005
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6   # the latter times the table's largest entry
# K4 against K3: the reference's bound (tests/test_kernel.py:630)
CROSS_RTOL, CROSS_ATOL = 2e-3, 2e-5
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s and
# FP32 operations/s outside the tensor cores
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12
# int32 operations/s: 132 SMs x 64 int32 lanes x 1.98 GHz
INT32_OPS_S = 132 * 64 * 1.98e9


def compare(got: torch.Tensor, ref: torch.Tensor, what: str):
    """Lane-by-lane check of the kernel against the plain version."""
    g = got.double().cpu().numpy()
    r = ref.double().cpu().numpy()
    if not (np.isfinite(g).all() and np.isfinite(r).all()):
        raise AssertionError(f"{what}: non-finite values")
    bad = ~np.isclose(g, r, rtol=RTOL, atol=ATOL)
    share = float(bad.reshape(len(g), -1).any(-1).mean())
    gf, rf = g.reshape(len(g), -1), r.reshape(len(r), -1)
    se = rf.std(0) / np.sqrt(len(rf)) + 1e-12
    mean_dev = float(np.max(np.abs(gf.mean(0) - rf.mean(0)) / se))
    max_abs = float(np.abs(g - r).max())
    if share > MAX_BAD_SHARE or mean_dev > 3.0:
        raise AssertionError(f"{what}: {share:.5f} of lanes outside the "
                             f"bound, mean off by {mean_dev:.2f} SE")
    return share, max_abs, mean_dev


def compare_cache(resf, resi, ref_f, ref_i, what: str) -> float:
    """Plane by plane: each float plane at most MAX_BAD_SHARE of lanes
    outside rtol/atol, the int planes at most MAX_BAD_SHARE of lanes
    differing. Returns the max |err| over the float planes."""
    if resf.shape != ref_f.shape or resi.shape != ref_i.shape:
        raise AssertionError(f"{what}: cache shapes differ")
    if not torch.isfinite(resf).all():
        raise AssertionError(f"{what}: non-finite cache entries")
    bad = ~torch.isclose(resf, ref_f, rtol=RTOL, atol=ATOL)
    worst = float(bad.float().mean(1).max())
    ints = float((resi != ref_i).any(0).float().mean())
    if worst > MAX_BAD_SHARE or ints > MAX_BAD_SHARE:
        raise AssertionError(f"{what}: a cache plane has {worst:.5f} of lanes "
                             f"outside the bound, the int planes {ints:.5f}")
    return float((resf - ref_f).abs().max())


def same_bits(got, ref, what: str) -> None:
    """K1's radiance, or K2's (radiance, resf, resi), against the plain
    version's on the same lanes, to the last bit."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for k, (a, b) in enumerate(zip(got, ref)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: output {k} differs from the plain "
                                 f"version's in {int((a != b).sum())} entries")


def compare_grads(got, ref, what: str, rtol=GRAD_RTOL,
                  atol=GRAD_ATOL) -> float:
    """Each table (dd, ds, de, denv[, dexp][, dta, dtb][, dti]) within rtol
    plus atol of its largest entry; returns the max |err|."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} tables, expected {len(ref)}")
    err = 0.0
    for k, (a, b) in enumerate(zip(got, ref)):
        tol = rtol * b.abs() + atol * max(1.0, float(b.abs().max()))
        if not torch.isfinite(a).all() or ((a - b).abs() > tol).any():
            raise AssertionError(f"{what}: table {k} outside the bound")
        err = max(err, float((a - b).abs().max()))
    return err


def k1_ops(static, cache, cfg) -> float:
    """FP32 operations (add, sub, mul, div, sqrt, min/max, one per
    transcendental call) that K1 must do for the lanes of a run, counted
    from csrc/wavefront_fwd.cu for a scene of fast-path planar rows and
    sphere lights (Veach): per surface in the closest-hit sweep 31 (planar)
    or 33 (sphere), 32 per hit for the normal and the emission MIS; below
    the horizon 62 for the frame and material, 6 for the shared azimuth,
    134 per light for its sample and BSDF evaluation, 90 for the BSDF
    sample and the extension. Of the nee="all" shadow sweeps only what the
    data surely needs is counted, as `k5_ops` counts it: each shadow ray
    that reached its light (a nonzero "B" plane of K2's cache for these
    lanes) tested every row whose skip bit for its light is clear, at 27 (a
    fast planar row), 34 (any other planar row) or 19 (a sphere) a row, and
    a lane-bounce with such a ray computed the shared terms of each row
    that some light does not skip once (33 a fast planar row, 13 a sphere).
    Blocked rays stop early and are left out, and the nee="single" sweep is
    not counted, so the count is a lower bound. Live lane-bounces come from
    K2's cache of the same lanes: a lane reaches bounce b > 0 iff its "tu"
    plane at b - 1 is not 0."""
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.scene import shapes as kshapes
    ix, _ = kwf.residual_layout(static, cfg)
    n = cache.shape[1]
    reached = [n] + [int((cache[ix[("tu", b)]] != 0).sum())
                     for b in range(cfg.max_depth)]
    planar, n_sp, n_l = static["planar"], len(static["spheres"]), len(
        static["lights"])
    hit = 31 * len(planar) + 33 * n_sp + 32
    shade = 62 + 6 + 134 * n_l + 90
    ops = float(sum(reached[:-1]) * (hit + shade) + reached[-1] * hit)
    if kwf.picks_one_light(cfg, n_l) or not n_l:
        return ops
    rows_skip, sph_skip = kwf._occl_skips(static, cfg)
    fast = [s["kind"] != kshapes.DISK and bool(s.get("fast"))
            for s in planar]
    ray_row = [sum(27 if fast[r] else 34 for r in range(len(planar))
                   if r not in rows_skip[i]) + 19 * (n_sp - len(sph_skip[i]))
               for i in range(n_l)]
    shared_row = (33 * sum(1 for r in range(len(planar)) if fast[r] and any(
        r not in rows_skip[i] for i in range(n_l)))
        + 13 * sum(1 for j in range(n_sp) if any(
            j not in sph_skip[i] for i in range(n_l))))
    for b in range(cfg.max_depth):
        lit = torch.stack([cache[ix[("B", b, i)]] != 0 for i in range(n_l)])
        ops += sum(ray_row[i] * int(lit[i].sum()) for i in range(n_l))
        ops += shared_row * int(lit.any(0).sum())
    return ops


def k4_ops(static, cache, cfg) -> float:
    """FP32 operations of K4 (csrc/wavefront_fwd.cu, MODE_REPLAY) for the
    lanes of a run: K1's (`k1_ops`, a lower bound, the shadow sweeps the
    data surely needs included) plus the adjoint terms, counted from the
    source: 9 per live lane-bounce for the hit emission, and below the
    horizon 21 per light (emission, colour adjoints), 3 for E_b and 31 for
    the tail peel and the extension's adjoint."""
    n_l = len(static["lights"])
    from kytpu_torch.kernels import wavefront as kwf
    ix, _ = kwf.residual_layout(static, cfg)
    n = cache.shape[1]
    reached = [n] + [int((cache[ix[("tu", b)]] != 0).sum())
                     for b in range(cfg.max_depth)]
    adj = sum(reached[:-1]) * (9 + 21 * n_l + 3 + 31) + reached[-1] * 9
    return k1_ops(static, cache, cfg) + float(adj)


def simt_share(static, cache, cfg, chunk: int) -> tuple:
    """SIMT efficiency of K1 and K2 on the lanes of K2's cache: the
    lane-bounces (a lane traces bounce 0 and each b > 0 whose "tu" plane
    at b - 1 is not 0) over 32 x each warp's iterations, one lane a thread
    (a warp of 32 consecutive lanes runs its longest path) and with
    dead-lane refill (a warp's chunk of `chunk` lanes handed to its 32
    slots in order as they free, as csrc/wavefront_fwd.cu does) ->
    (lane-bounces, before, after)."""
    from kytpu_torch.kernels import wavefront as kwf
    ix, _ = kwf.residual_layout(static, cfg)
    n = cache.shape[1]
    iters = torch.ones(n, dtype=torch.int64, device=cache.device)
    for b in range(cfg.max_depth):
        iters += (cache[ix[("tu", b)]] != 0).long()
    iters = iters.cpu().numpy()
    total = int(iters.sum())
    pad = -n % chunk
    lanes = np.concatenate([iters, np.zeros(pad, np.int64)])
    before = 32 * int(lanes.reshape(-1, 32).max(1).sum())
    lanes = lanes.reshape(-1, chunk)
    free = lanes[:, :32].copy()
    rows = np.arange(len(lanes))
    for j in range(32, chunk):
        s = free.argmin(1)
        free[rows, s] += lanes[:, j]
    after = 32 * int(free.max(1).sum())
    return total, total / before, total / after


def k3_ops(static, cfg, n: int) -> float:
    """FP32 operations of K3 (csrc/wavefront_bwd_res.cu), which walks every
    bounce of every lane: 45 per bounce below the horizon plus 27 per NEE
    ("B") plane of the cache, 6 at the horizon."""
    from kytpu_torch.kernels import wavefront as kwf
    ix, _ = kwf.residual_layout(static, cfg)
    n_b = sum(1 for t in ix if t[0] == "B" and t[1] == 0)
    return float(n * (cfg.max_depth * (45 + 27 * n_b) + 6))


def k5_ops(tables, cache, cfg) -> float:
    """FP32 operations (as `k1_ops` counts them) that K5 must do for the
    lanes of a run, counted from csrc/bigscene_fwd.cu: a row of the
    closest-hit sweep costs 39 (triangle), 38 (rect), 26 (disk) or 34
    (sphere); a hit 32 for its normal and the emission MIS; a bounce below
    the horizon K1's 62 + 6 + 134 a light + 90 for the shading. Of the
    occlusion sweep only what the data surely needs is counted: each shadow
    ray that reached its light (a nonzero "B" plane of K6's cache for these
    lanes) tested every row, at 27 (planar), 28 (disk) or 19 (sphere) a
    row, and a lane-bounce with such a ray computed each row's shared terms
    once (33, 11, 13). Blocked rays are left out, so the count is a lower
    bound. Live lane-bounces as in `k1_ops`."""
    from kytpu_torch.kernels import bigscene as kbs
    st = tables.static
    n_l = len(st["lights"])
    ix, _ = kbs.layout_of(st, cfg)
    n = cache.shape[1]
    reached = [n] + [int((cache[ix[("tu", b)]] != 0).sum())
                     for b in range(cfg.max_depth)]
    n_tri, n_rect, n_disk, n_sph = tables.counts
    sweep = 39 * n_tri + 38 * n_rect + 26 * n_disk + 34 * n_sph + 32
    ray_row = 27 * (n_tri + n_rect) + 28 * n_disk + 19 * n_sph
    shared_row = 33 * (n_tri + n_rect) + 11 * n_disk + 13 * n_sph
    rays = vertices = 0
    for b in range(cfg.max_depth):
        lit = torch.stack([cache[ix[("B", b, i)]] != 0 for i in range(n_l)])
        rays += int(lit.sum())
        vertices += int(lit.any(0).sum())
    shade = 62 + 6 + 134 * n_l + 90
    return float(sum(reached) * sweep + sum(reached[:-1]) * shade
                 + rays * ray_row + vertices * shared_row)


def k8_ops(tables, cache, cfg) -> float:
    """FP32 operations of K8 (csrc/bigscene_fwd.cu, MODE_REPLAY) for the
    lanes of a run: K5's (`k5_ops`, a lower bound) plus the adjoint terms,
    counted from the source: 9 per live lane-bounce for the hit emission's
    adjoint and E_b, 12 more where the scene has an environment light, and
    below the horizon 21 per light (the emission and colour adjoints), 3 for
    E_b and 31 for the tail peel and the extension's adjoint. Live
    lane-bounces as in `k1_ops`, from K6's cache of the same lanes."""
    from kytpu_torch.kernels import bigscene as kbs
    st = tables.static
    n_l = len(st["lights"])
    ix, _ = kbs.layout_of(st, cfg)
    reached = [cache.shape[1]] + [int((cache[ix[("tu", b)]] != 0).sum())
                                  for b in range(cfg.max_depth)]
    env = 12 if ("wenv", 0) in ix else 0
    adj = sum(reached) * (9 + env) + sum(reached[:-1]) * (21 * n_l + 3 + 31)
    return k5_ops(tables, cache, cfg) + float(adj)


# FP32 operations of csrc/bigscene_fwd.cu's cull, counted from the source:
# a closest-hit block test (`block_meets`), a ray's slack (`cull_slack`), a
# shadow ray's block test with its offset origin
BLOCK_TEST_OPS, SLACK_OPS, SHADOW_BLOCK_OPS = 25, 14, 32


def same_as_cull_off(tables, cfg, lanes, g, got, tag: str) -> None:
    """K5's radiance, K6's (radiance, resf, resi) and K8's gradient `got`
    under cfg.cull against the same build's launches with cull "off", to
    the last bit (the cull skips only blocks no lane's ray can meet)."""
    from kytpu_torch.kernels import bigscene as kbs
    off = dataclasses.replace(cfg, cull="off")
    o, d, seed, si, pix = lanes
    k5, k6, k8 = got
    same_bits(k5, kbs.trace_lanes(tables, off, o, d, seed, si, pix),
              f"K5 with cull={cfg.cull!r} against cull='off', {tag}")
    same_bits(k6, kbs.trace_lanes(tables, off, o, d, seed, si, pix,
                                  residual=True),
              f"K6 with cull={cfg.cull!r} against cull='off', {tag}")
    same_bits(tuple(k8), tuple(kbs.bwd_replay(tables, off, o, d, seed, si,
                                              pix, g, k5)),
              f"K8 with cull={cfg.cull!r} against cull='off', {tag}")


class CullTally:
    """The lane-by-lane pass counts of `wf_cull_counts`:
    the (blocks + superblocks, 4) bounds `bnd` of nb blocks, each block's
    superblock `sb_of`; superblocks and blocks passed by a lane's rays and
    by a warp of 32 lanes in lane order, for the closest-hit ("hit") and
    the occlusion ("occ") sweeps, and the FP32 operations counted in
    "ops"."""

    def __init__(self, bnd, nb: int, sb_of, n_sup: int, n: int):
        self.bnd, self.sup, self.sb_of = bnd[:nb], bnd[nb:], sb_of
        self.nb, self.n_sup, self.n = nb, n_sup, n
        self.stats = {k: 0.0 for k in (
            "ops", "hit_sup", "hit_sup_w", "hit_blk", "hit_blk_w", "hit_n",
            "hit_w_n", "occ_sup", "occ_sup_w", "occ_blk", "occ_blk_w",
            "occ_n", "occ_w_n")}

    def passes(self, oo, dd, t1):
        """(superblock, block within a passed superblock) passes."""
        from kytpu_torch.kernels import bigscene as kbs
        slack, inv = kbs.cull_slack_plain(oo, dd)
        oks = kbs.block_meets_plain(self.sup, oo, dd, inv, t1, slack)
        okb = kbs.block_meets_plain(self.bnd, oo, dd, inv, t1, slack) \
            & oks[:, self.sb_of]
        return oks, okb

    def warp_any(self, lanes, ok):
        w = torch.zeros((self.n // 32 + 1, ok.shape[1]), dtype=torch.int32,
                        device=ok.device)
        w.index_add_(0, lanes // 32, ok.int())
        return float((w > 0).sum())

    def tally(self, kind, lanes, oks, okb):
        st = self.stats
        st[f"{kind}_sup"] += float(oks.sum())
        st[f"{kind}_blk"] += float(okb.sum())
        st[f"{kind}_sup_w"] += self.warp_any(lanes, oks)
        st[f"{kind}_blk_w"] += self.warp_any(lanes, okb)
        st[f"{kind}_n"] += len(lanes)
        st[f"{kind}_w_n"] += float(torch.unique(lanes // 32).numel())

    def result(self, plain) -> dict:
        st = self.stats
        out = {"ops": st["ops"], "blocks": self.nb, "supers": self.n_sup,
               "plain": plain}
        for kind in ("hit", "occ"):
            for lvl, cnt in (("sup", self.n_sup), ("blk", self.nb)):
                out[f"{kind}_{lvl}"] = st[f"{kind}_{lvl}"] / max(
                    1.0, st[f"{kind}_n"] * cnt)
                out[f"{kind}_{lvl}_warp"] = st[f"{kind}_{lvl}_w"] / max(
                    1.0, st[f"{kind}_w_n"] * cnt)
        return out


def swept_counts(tables, cfg, o, d, seed, si=None, pix=None,
                 warp: int = 32, stats: dict | None = None) -> tuple:
    """(rows, sweeps, bounds, tri rows, tri bounds): what
    csrc/bigscene_fwd.cu's counters add on these lanes (`kernel.<k>.rows`,
    `.sweeps`, `.bounds`, `.rows.tri`, `.bounds.tri`), worked out from
    the rays the plain K6 traces (kbs._closest_hit and kbs._occluded
    wrapped while it runs) with the kernel's tree walk (`walk`): each lane
    of a sweep (the live ones for the closest hit, those with a wanted
    shadow ray in the chunk of NEE_CHUNK lights for occlusion) walks each
    class's tree (`kbs.tree_bounds`) alone, in table order, going on to
    the next entry where its rays meet an entry (`kbs.node_meets_plain`:
    the closest hit's running t_best; the open shadow rays, a block's rows
    then tested for those that meet it) and to its skip where they do not,
    an occlusion walk ending once every ray is blocked. Its warp (`warp`
    lanes in lane order; 1: the host build's warps of one) runs the walks
    in step: a node step while some lane has no block pending, which each
    lane with room for one more of kbs.LEAF_BUF pending blocks takes, else
    a leaf phase, which tests each lane's first pending block. rows: the
    rows of the largest such block of each leaf phase, bounds: the node
    steps, both times the warp's lanes in the sweep; sweeps: the lanes in
    each sweep; tri rows and tri bounds: rows and bounds of the walks of
    the tri class's tree alone. stats, where given, gets "lane_rows" and "lane_bounds" (a
    lane's own rows and node steps, summed over its sweeps), "phases" (leaf
    phases, summed over the warps' sweeps), "blocks" (the distinct blocks
    of each leaf phase, summed likewise), "ops" (the FP32 operations of
    `k5_ops` with each sweep culled by the lane's own walk: each node test,
    at BLOCK_TEST_OPS, or SHADOW_BLOCK_OPS a shadow ray it tests; each row
    of its tested blocks at `k5_ops`' costs, a shadow ray's for each ray
    tested plus the shared terms; a ray's slack and set-up; the shading of
    each lane-bounce) and "plain" (the plain K6's (radiance, resf,
    resi))."""
    from kytpu_torch.kernels import bigscene as kbs
    from kytpu_torch.kernels import shading as ksh
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.kernels.v3 import V3
    cull = cfg.cull != "off"
    counts, U, B = tables.counts, kbs.UNROLL, kbs.LEAF_BUF
    nbs = [-(-c // U) for c in counts]
    bnd, links = tables.bnd, tables.links.long()
    # each class's entries: its root is the first, its skip the class's end
    start = [0]
    for c in range(4):
        start.append(start[-1] + (int(links[start[-1], 0]) - start[-1]
                                  if nbs[c] else 0))
    tot = {"rows": 0, "sweeps": 0, "bounds": 0, "tri_rows": 0,
           "tri_bounds": 0}
    st = {"lane_rows": 0, "lane_bounds": 0, "phases": 0, "blocks": 0,
          "ops": 0.0}
    # k5_ops' costs of a row: closest hit, shadow ray, shared terms
    hit_row, ray_row, shared_row = (39, 38, 26, 34), (27, 27, 28, 19), (
        33, 33, 11, 13)

    def sub(v, li):
        return V3(v.x[li], v.y[li], v.z[li])

    def col(v):
        return V3(v.x[:, None], v.y[:, None], v.z[:, None])

    def rows_in(c, blk, G):
        """The rows of each lane's block, (C, columns, U), NaN past the
        class's last row (no row test takes NaN), and their table rows (C,
        U)."""
        s = blk[:, None] * U + torch.arange(U, device=blk.device)
        ok = s < counts[c]
        s = s.clamp(max=counts[c] - 1)
        g = torch.where(ok[..., None], G[s], math.nan)
        return g.permute(0, 2, 1), s

    def walk(c, idx, live, node_hits, leaf):
        """Each lane of idx (launch positions) walks class c's tree, its
        warp in step: node_hits(pos, e) -> (whether the rays of the lanes
        at positions pos of idx meet their entries e, each lane's rays that
        do or None); leaf(pos, blk, rays) tests the blocks' rows -> whether
        each lane still looks for something. Adds the warps' node steps and
        leaf phases' rows."""
        n, dev = len(idx), idx.device
        wid, w = torch.unique(idx // warp, return_inverse=True)
        nw = len(wid)
        n_w = torch.bincount(w, minlength=nw)
        e = torch.full((n,), start[c], dtype=torch.long, device=dev)
        buf = torch.full((n, B), -1, dtype=torch.long, device=dev)
        pay = [None] * B
        done = ~live
        nodes_w = torch.zeros(nw, dtype=torch.long, device=dev)
        rows_w = torch.zeros_like(nodes_w)

        def any_w(m):
            return torch.zeros(nw, dtype=torch.bool, device=dev).index_put_(
                (w[m],), torch.ones(1, dtype=torch.bool, device=dev))

        while True:
            w_node = any_w(~done & (buf[:, 0] < 0))
            hasb = buf[:, 0] >= 0
            w_leaf = any_w(hasb) & ~w_node
            if not bool(w_node.any() | w_leaf.any()):
                break
            nodes_w += w_node.long()
            ns = (w_node[w] & ~done & (buf[:, -1] < 0)).nonzero().reshape(-1)
            lf = (w_leaf[w] & hasb).nonzero().reshape(-1)
            if len(ns):
                st["lane_bounds"] += len(ns)
                m, rays = node_hits(ns, e[ns])
                blk = links[e[ns], 1]
                at_leaf = m & (blk >= 0)
                got = ns[at_leaf]
                slot = (buf[got] >= 0).sum(1)
                buf[got, slot] = blk[at_leaf]
                if rays is not None:
                    for q in range(B):
                        if pay[q] is None:
                            pay[q] = torch.zeros((n, rays.shape[1]),
                                                 dtype=torch.bool, device=dev)
                        pay[q][got[slot == q]] = rays[at_leaf][slot == q]
                e[ns] = torch.where(m, e[ns] + 1, links[e[ns], 0])
                done[ns] = e[ns] >= start[c + 1]
            if len(lf):
                blk = buf[lf, 0]
                r = torch.clamp(counts[c] - blk * U, max=U)
                rows_w += torch.zeros_like(rows_w).scatter_reduce_(
                    0, w[lf], r, "amax")
                st["lane_rows"] += int(r.sum())
                st["phases"] += int(w_leaf.sum())
                st["blocks"] += int(torch.unique(
                    w[lf] * (nbs[c] + 1) + blk).numel())
                alive = leaf(lf, blk, None if pay[0] is None else pay[0][lf])
                buf[lf] = torch.cat([buf[lf, 1:], torch.full_like(
                    buf[lf, :1], -1)], 1)
                for q in range(B - 1):
                    if pay[q] is not None:
                        pay[q][lf] = pay[q + 1][lf]
                dead = lf[~alive]
                done[dead] = True
                buf[dead] = -1
        bounds, rows = int((nodes_w * n_w).sum()), int((rows_w * n_w).sum())
        tot["bounds"] += bounds
        tot["rows"] += rows
        if c == 0:
            tot["tri_bounds"] += bounds
            tot["tri_rows"] += rows

    real_hit, real_occ = kbs._closest_hit, kbs._occluded

    def hit(bt, o_, d_, live):
        idx = live.nonzero().reshape(-1)
        tot["sweeps"] += len(idx)
        st["ops"] += len(idx) * (SLACK_OPS + 32)
        oo, dd = sub(o_, idx), sub(d_, idx)
        slack, inv = kbs.cull_slack_plain(oo, dd)
        t_best = torch.full_like(oo.x, math.inf)
        for c, name in enumerate(kbs.CLASSES):
            if not nbs[c]:
                continue
            G, _ = bt.cls(name)

            def node_hits(pos, e):
                if not cull:
                    return torch.ones_like(pos, dtype=torch.bool), None
                st["ops"] += len(pos) * BLOCK_TEST_OPS
                return kbs.node_meets_plain(bnd[e], sub(oo, pos),
                                            sub(dd, pos), inv[pos],
                                            t_best[pos], slack[pos]), None

            def leaf(pos, blk, rays, c=c, name=name, G=G):
                g, _ = rows_in(c, blk, G)
                st["ops"] += float(torch.clamp(counts[c] - blk * U, max=U)
                                   .sum()) * hit_row[c]
                t = kbs._closest_class(name, g, col(sub(oo, pos)),
                                       col(sub(dd, pos))).min(1)[0]
                t_best[pos] = torch.minimum(t, t_best[pos])
                return torch.ones_like(pos, dtype=torch.bool)

            walk(c, idx, torch.ones_like(idx, dtype=torch.bool), node_hits,
                 leaf)
        return real_hit(bt, o_, d_, live)

    def occ(bt, hp, ns, rays, wants, robust, own):
        for i0 in range(0, len(rays), kwf.NEE_CHUNK):
            chunk = list(range(i0, min(len(rays), i0 + kwf.NEE_CHUNK)))
            need = torch.zeros_like(hp.x, dtype=torch.bool)
            for q in chunk:
                need = need | wants[q]
            idx = need.nonzero().reshape(-1)
            tot["sweeps"] += len(idx)
            st["ops"] += sum(int(wants[q][idx].sum())
                             for q in chunk) * (SLACK_OPS + 6)
            hpl, nsl = sub(hp, idx), sub(ns, idx)
            rs = []
            for q in chunk:
                wi, tmax = rays[q]
                wi, tmax = sub(wi, idx), tmax[idx]
                nd = nsl.dot(wi)
                se = torch.where(nd < 0, -ksh.OFF, ksh.OFF)
                og = hpl + nsl * se
                slack, inv = kbs.cull_slack_plain(og, wi)
                rs.append((wi, tmax - se * nd if robust else tmax, se, nd,
                           og, slack, inv))
            owns = [own[q] if robust else None for q in chunk]
            open_ = torch.stack([wants[q][idx] for q in chunk], 1)
            for c, name in enumerate(kbs.CLASSES):
                if not nbs[c]:
                    continue
                G, grows = bt.cls(name)

                def node_hits(pos, e):
                    if not cull:
                        m = open_[pos]
                    else:
                        st["ops"] += float(open_[pos].sum()) * \
                            SHADOW_BLOCK_OPS
                        b = bnd[e]
                        m = open_[pos] & torch.stack(
                            [kbs.node_meets_plain(b, sub(r[4], pos),
                                                  sub(r[0], pos), r[6][pos],
                                                  r[1][pos], r[5][pos])
                             for r in rs], 1)
                    return m.any(1), m

                def leaf(pos, blk, test, c=c, name=name, G=G, grows=grows):
                    g, s = rows_in(c, blk, G)
                    st["ops"] += float((torch.clamp(
                        counts[c] - blk * U, max=U) * (
                        test.sum(1) * ray_row[c] + shared_row[c])).sum())
                    crays = [(col(sub(r[0], pos)), r[1][pos, None],
                              r[2][pos, None], r[3][pos, None]) for r in rs]
                    hits = kbs._occluded_class(
                        name, g, grows[s], col(sub(hpl, pos)),
                        col(sub(nsl, pos)), crays, owns)
                    open_[pos] &= ~(torch.stack(hits, 1) & test)
                    return open_[pos].any(1)

                walk(c, idx, open_.any(1), node_hits, leaf)
        return real_occ(bt, hp, ns, rays, wants, robust, own)

    kbs._closest_hit, kbs._occluded = hit, occ
    try:
        st["plain"] = kbs.trace_lanes_plain(tables, cfg, o, d, seed, si, pix,
                                            residual=True)
    finally:
        kbs._closest_hit, kbs._occluded = real_hit, real_occ
    ix, _ = kbs.layout_of(tables.static, cfg)
    n_l = len(tables.static["lights"])
    st["ops"] += (o.shape[0] + sum(
        int((st["plain"][1][ix[("tu", b)]] != 0).sum())
        for b in range(cfg.max_depth - 1))) * (62 + 6 + 134 * n_l + 90)
    if stats is not None:
        stats.update(st)
    return (tot["rows"], tot["sweeps"], tot["bounds"], tot["tri_rows"],
            tot["tri_bounds"])


def same_as_cull_off_wf(tables, cfg, lanes, g, got, tag: str) -> None:
    """K1's radiance, K2's (radiance, resf, resi) and K4's gradient `got`
    past REFILL_MAX_ROWS surfaces under cfg.cull against the same build's
    launches with cull "off", which sweeps every row in the visit order, to
    the last bit (`same_as_cull_off`'s sibling for csrc/wavefront_fwd.cu's
    step 5)."""
    from kytpu_torch.kernels import wavefront as kwf
    if tables.vis is None:
        raise AssertionError(f"{tag}: not on the culled route")
    off = dataclasses.replace(cfg, cull="off")
    o, d, seed, si, pix = lanes
    k1, k2, k4 = got
    same_bits(k1, kwf.trace_lanes(tables, off, o, d, seed, si, pix),
              f"K1 with cull={cfg.cull!r} against cull='off', {tag}")
    same_bits(k2, kwf.trace_lanes(tables, off, o, d, seed, si, pix,
                                  residual=True),
              f"K2 with cull={cfg.cull!r} against cull='off', {tag}")
    same_bits(tuple(k4), tuple(kwf.bwd_replay(tables, off, o, d, seed, si,
                                              pix, g, k1)),
              f"K4 with cull={cfg.cull!r} against cull='off', {tag}")


def wf_cull_counts(tables, cfg, o, d, seed, si=None, pix=None) -> dict:
    """What the cull leaves of K1's work past REFILL_MAX_ROWS surfaces
    (csrc/wavefront_fwd.cu step 5), from the rays that the plain K2 traces
    (kwf._closest_hit and kwf._any_hit_multi wrapped while it runs; the
    lanes that reach a bounce and the shadow rays that reach their light
    from its cache): "ops", the FP32 operations of `k1_ops` with each sweep
    culled by the lane's own rays (a lane-bounce tests every superblock
    bound, the block bounds of the superblocks its ray meets over [0, t], t
    its hit, and the rows of the blocks it meets, at `k1_ops`' costs a row;
    a shadow ray that reached its light likewise over [0, tmax] from its
    offset origin, the rows whose skip bit for its light is clear; the
    shared terms of the rows of the blocks one of a vertex's rays meets);
    the pass rates of the superblocks and blocks by a lane's rays and by a
    warp of 32 consecutive lanes (a warp's lanes without refill), for the
    closest-hit ("hit") and occlusion ("occ") sweeps; "plain", the plain
    K2's (radiance, resf, resi). nee="all" only, as `k1_ops` counts it."""
    from kytpu_torch.kernels import bigscene as kbs
    from kytpu_torch.kernels import shading as ksh
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.kernels.v3 import V3
    from kytpu_torch.scene import shapes as kshapes
    st = tables.static
    planar, n_l = st["planar"], len(st["lights"])
    n_pl, n_sp = len(planar), len(st["spheres"])
    ix, _ = kwf.residual_layout(st, cfg)
    dev = tables.bnd.device
    rows_skip, sph_skip = kwf._occl_skips(st, cfg)
    vis = tables.vis.cpu().numpy()
    # each block's rows at k1_ops' costs: closest hit, a shadow ray of
    # light i (its skip bits), the shared terms
    fast = [s["kind"] != kshapes.DISK and bool(s.get("fast")) for s in planar]
    w_hit, w_ray, w_sh, sb_of = [], [], [], []
    n_sup = 0
    for nr, off, is_pl in ((n_pl, 0, True), (n_sp, n_pl, False)):
        nb_c = -(-nr // kbs.UNROLL)
        for b in range(nb_c):
            rs = vis[off + b * kbs.UNROLL:off + min(nr, (b + 1) * kbs.UNROLL)]
            skip = [rows_skip[i] if is_pl else sph_skip[i]
                    for i in range(n_l)]
            ray_cost = [(27 if fast[r] else 34) if is_pl else 19 for r in rs]
            w_hit.append((31 if is_pl else 33) * len(rs))
            w_ray.append([sum(c for r, c in zip(rs, ray_cost)
                              if r not in skip[i]) for i in range(n_l)])
            w_sh.append(sum((33 if fast[r] else 0) if is_pl else 13
                            for r in rs
                            if any(r not in skip[i] for i in range(n_l))))
            sb_of.append(n_sup + b // kwf.SUPER)
        n_sup += -(-nb_c // kwf.SUPER)
    nb = len(w_hit)
    f64 = dict(dtype=torch.float64, device=dev)
    w_hit = torch.tensor(w_hit, **f64)
    w_ray = torch.tensor(w_ray, **f64).reshape(nb, n_l)
    w_sh = torch.tensor(w_sh, **f64)
    sb_of = torch.tensor(sb_of, dtype=torch.long, device=dev)
    per_sup = torch.bincount(sb_of, minlength=n_sup).double()
    n = o.shape[0]
    step = max(32, (1 << 22) // max(nb, 1) // 32 * 32)
    ct = CullTally(tables.bnd, nb, sb_of, n_sup, n)
    stats, passes, tally = ct.stats, ct.passes, ct.tally
    hits, occs = [], []
    real_hit, real_occ = kwf._closest_hit, kwf._any_hit_multi

    def sub(v, li):
        return V3(v.x[li], v.y[li], v.z[li])

    def hit(static, o_, d_):
        out = real_hit(static, o_, d_)
        hits.append((o_, d_, out[0]))
        return out

    def occ(static, hp, ns, rays, skips, robust=False, sphere_skips=None,
            nd=None):
        out = real_occ(static, hp, ns, rays, skips, robust=robust,
                       sphere_skips=sphere_skips, nd=nd)
        occs.append((hp, ns, rays, robust))
        return out

    kwf._closest_hit, kwf._any_hit_multi = hit, occ
    try:
        plain = kwf.trace_lanes_plain(tables, cfg, o, d, seed, si, pix,
                                      residual=True)
    finally:
        kwf._closest_hit, kwf._any_hit_multi = real_hit, real_occ
    resf = plain[1]
    live = [torch.ones(n, dtype=torch.bool, device=dev)] + [
        resf[ix[("tu", b)]] != 0 for b in range(cfg.max_depth)]
    for b, (o_, d_, t) in enumerate(hits):
        idx = live[b].nonzero().reshape(-1)
        for c0 in range(0, len(idx), step):
            li = idx[c0:c0 + step]
            oks, okb = passes(sub(o_, li), sub(d_, li), t[li])
            stats["ops"] += float((okb.double() @ w_hit).sum()
                                  + (oks.double() @ per_sup).sum()
                                  * BLOCK_TEST_OPS) + len(li) * (
                BLOCK_TEST_OPS * n_sup + SLACK_OPS + 32)
            tally("hit", li, oks, okb)
    # only the shadow rays that reached their light (a nonzero "B" plane)
    for b, (hp, ns, rays, robust) in enumerate(occs):
        reached = [resf[ix[("B", b, i)]] != 0 for i in range(n_l)]
        idx = torch.stack(reached).any(0).nonzero().reshape(-1)
        for c0 in range(0, len(idx), step):
            li = idx[c0:c0 + step]
            union = torch.zeros((len(li), nb), dtype=torch.bool, device=dev)
            for i, (wi, tmax) in enumerate(rays):
                r = reached[i][li]
                if not bool(r.any()):
                    continue
                lr = li[r]
                wr = sub(wi, lr)
                nd = sub(ns, lr).dot(wr)
                se = torch.where(nd < 0, -ksh.OFF, ksh.OFF)
                tm = tmax[lr] - se * nd if robust else tmax[lr]
                oks, okb = passes(sub(hp, lr) + sub(ns, lr) * se, wr, tm)
                union[r] |= okb
                stats["ops"] += float((okb.double() @ w_ray[:, i]).sum()
                                      + (oks.double() @ per_sup).sum()
                                      * SHADOW_BLOCK_OPS) + len(lr) * (
                    SHADOW_BLOCK_OPS * n_sup + SLACK_OPS + 6)
                tally("occ", lr, oks, okb)
            stats["ops"] += float((union.double() @ w_sh).sum())
    n_b = [int(v.sum()) for v in live]
    stats["ops"] += sum(n_b[:-1]) * (62 + 6 + 134 * n_l + 90)
    return ct.result(plain)


def pass_rates(c: dict) -> str:
    """`wf_cull_counts`' pass rates as words."""
    return ", ".join(
        f"{what} superblocks {c[f'{k}_sup']:.4f} a lane, "
        f"{c[f'{k}_sup_warp']:.4f} a warp, blocks {c[f'{k}_blk']:.4f} a lane,"
        f" {c[f'{k}_blk_warp']:.4f} a warp"
        for k, what in (("hit", "closest hit:"), ("occ", "occlusion:")))


def bound_ms(n_bytes: float, n_ops: float):
    """(least time in ms, what bounds it) on the H100's peaks."""
    t_b, t_o = n_bytes / HBM_BYTES_S, n_ops / FP32_OPS_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def jittered_rays(scene, n: int, seed: int):
    from kytpu_torch.scene.scene import generate_rays
    cam = scene.camera
    npix = cam.width * cam.height
    rng = np.random.default_rng(seed)
    pid = np.arange(n) % npix
    pf = np.stack([pid % cam.width + rng.random(n),
                   pid // cam.width + rng.random(n)], -1).astype(np.float32)
    o, d = generate_rays(cam, torch.from_numpy(pf).cuda())
    si = torch.from_numpy((np.arange(n) // npix).astype(np.int32)).cuda()
    return o, d, si, torch.from_numpy(pid.astype(np.int32)).cuda()


@contextlib.contextmanager
def recording(kmod):
    """While the block runs, keep the arguments and (detached) result of
    the last trace_lanes, bwd_res and bwd_replay call of the kernel module
    kmod (kernels/wavefront.py or kernels/bigscene.py: the diff tracers look
    them up in their module). The colour, exponent and texture tables are
    copied at the call: an optimizer step later updates the parameters they
    share storage with."""
    seen = {}
    real = {nm: getattr(kmod, nm) for nm in ("trace_lanes", "bwd_res",
                                             "bwd_replay")
            if hasattr(kmod, nm)}

    def wrap(nm):
        def fn(tables, *args, **kw):
            out = real[nm](tables, *args, **kw)
            seen[nm] = (dataclasses.replace(tables, **{
                k: getattr(tables, k).clone() for k in (
                    "diffuse", "specular", "emission", "exponent",
                    "light_emit", "env", "texa", "texb", "timg")
                if hasattr(tables, k)}),
                args, kw, tuple(t.detach() for t in out)
                if isinstance(out, tuple) else out.detach())
            return out
        return fn

    for nm in real:
        setattr(kmod, nm, wrap(nm))
    try:
        yield seen
    finally:
        for nm, fn in real.items():
            setattr(kmod, nm, fn)


def cuda_time_ms(fn, reps: int):
    """(ms per call of fn, fn's last output), from CUDA events after one
    warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, out


# device kernels by name in a profile, mangled or demangled (K3's
# sum_cols_kernel: no K4 runs in the profiled windows)
K1_NAMES = ("wavefront_fwd_kernel<0,", "wavefront_fwd_kernelILi0E")
K2_NAMES = ("wavefront_fwd_kernel<1,", "wavefront_fwd_kernelILi1E")
# the sums by tag (csrc/tag_sums.cu) that finish the row-tagged backwards
TAG_NAMES = ("tag_hist_kernel", "scan_reduce_kernel", "scan_top_kernel",
             "scan_down_kernel", "tag_scatter_kernel", "tag_starts_kernel",
             "tag_bounds_kernel", "seg_pieces_kernel", "seg_piece_kernel",
             "seg_finish_kernel")
K3_NAMES = ("bwd_res_kernel", "sum_cols_kernel") + TAG_NAMES
K5_NAMES = ("bigscene_fwd_kernel<0,", "bigscene_fwd_kernelILi0E")
K6_NAMES = ("bigscene_fwd_kernel<1,", "bigscene_fwd_kernelILi1E")
K7_NAMES = ("bigscene_bwd_lanes", "sum_partials_kernel") + TAG_NAMES
K8_NAMES = ("bigscene_fwd_kernel<2,", "bigscene_fwd_kernelILi2E",
            "sum_partials_kernel") + TAG_NAMES


def once_ms(fn):
    """(ms of one call of fn, its output), from CUDA events, not warmed:
    for the plain versions, which take seconds at the main path's sizes."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def pixel_centre_rays(scene, n: int):
    """benchmarks/run.py's lanes: pixel centres, lane i at pixel i mod
    W*H."""
    from kytpu_torch.scene.scene import generate_rays
    cam = scene.camera
    pid = torch.arange(n, device="cuda") % (cam.width * cam.height)
    pf = torch.stack([(pid % cam.width).float() + 0.5,
                      (pid // cam.width).float() + 0.5], -1)
    return generate_rays(cam, pf)


def device_profile(fn, kernels: dict):
    """Run fn once under torch.profiler -> (device busy ms, {name: ms in
    the device kernels whose name holds one of kernels[name]}, number of
    device kernels). Busy time is the union of the device kernels'
    intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_warm()
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and WARM_NAME not in e.name),
                 key=lambda e: e.time_range.start)
    busy_us, end = 0.0, float("-inf")
    for e in evs:
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
    mine = {k: sum(e.time_range.elapsed_us() for e in evs
                   if any(p in e.name for p in pats)) / 1e3
            for k, pats in kernels.items()}
    for k, ms in mine.items():
        if ms == 0:
            raise AssertionError(f"the profile shows no {k} kernel")
    return busy_us / 1e3, mine, len(evs)


# profiler_warm's kernels, dropped from every profile: no measured path
# runs digamma
WARM_NAME = "digamma"


def profiler_warm() -> None:
    """Small kernels, waited for, at the start of a profiled window: the
    trace kept no record of a window's first kernels (early in a run the
    first, K7's lane pass or K8's replay kernel; late in a run the first
    four, the row-tagged K3's lane kernel among them, while a new process
    kept them all), so those are these, 16 of them."""
    x = torch.zeros(1, device="cuda")
    for _ in range(16):
        x.digamma_()
    torch.cuda.synchronize()


def kernel_split(fn, top: int = 6) -> str:
    """fn's device time under torch.profiler, by device kernel, the longest
    first (names cut to 60 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_warm()
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and WARM_NAME not in e.name:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    parts = sorted(by.items(), key=lambda kv: -kv[1])
    return (f"{sum(by.values()):.3f} ms in {len(by)} kernels: " + "; ".join(
        f"{nm[:60]} {ms:.3f} ms" for nm, ms in parts[:top]))


def recorded_tag_sets(fn) -> list:
    """fn() with kernels/tag_sums.py's segment_sums recorded: the (dout,
    tags, m_tags, n_planes, n_cols, mask) of each call (copies), the tagged
    entries that K3, K4, K7 and K8 sum by row or texel."""
    from kytpu_torch.kernels import tag_sums as kts
    seen, real = [], kts.segment_sums

    def rec(dout, tags, m_tags, n_planes, n_cols, mask=-1):
        seen.append((dout.clone(), tags.clone(), m_tags, n_planes, n_cols,
                     mask))
        return real(dout, tags, m_tags, n_planes, n_cols, mask)

    kts.segment_sums = rec
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        kts.segment_sums = real
    return seen


def check_tag_sums(sets, what: str) -> list:
    """Each recorded set (`recorded_tag_sets`): the card's tag sort against
    torch.sort(stable=True) (kernels/tag_sums.py sort_tags), perm and
    starts to the last index, the split segment sums against
    segment_sums_plain and against themselves, bit for bit; then the sort,
    its plain version, one torch.sort and the sums timed, the plain sums
    once, and the bounds: the sort reads each key once and writes perm and
    starts, the sums read each tagged entry's values and its place in perm
    and write the (M, PB) table -> a dict a set."""
    from kytpu_torch.kernels import tag_sums as kts
    out = []
    for dout, tags, m, B, PB, mask in sets:
        tag = (f"{what}: {tags.numel()} entries of {m + 1} tags"
               f"{' (row mask)' if mask != -1 else ''}, {PB} columns")
        perm, starts = kts.tag_sort(tags, m, mask)
        rp, rs = kts.sort_tags(tags, m, mask)
        if perm.dtype != torch.int32 or starts.dtype != torch.int32:
            raise AssertionError(f"tag sort {tag}: not int32")
        if not (torch.equal(perm.long(), rp) and torch.equal(starts.long(),
                                                             rs)):
            raise AssertionError(f"tag sort {tag}: not torch.sort's order")
        n = dout.shape[1]
        seg = kts.seg_sums(dout, perm, starts, n, B, PB)
        same_bits(seg, kts.segment_sums_plain(dout, rp, rs, n, B, PB),
                  f"segment sums {tag} against segment_sums_plain")
        same_bits(kts.seg_sums(dout, perm, starts, n, B, PB), seg,
                  f"segment sums {tag} again")
        keys = (tags & mask).reshape(-1)
        sort_ms, _ = cuda_time_ms(lambda: kts.tag_sort(tags, m, mask), 5)
        plain_sort_ms, _ = cuda_time_ms(lambda: kts.sort_tags(tags, m, mask),
                                        5)
        lib_sort_ms, _ = cuda_time_ms(lambda: torch.sort(keys, stable=True),
                                      5)
        seg_ms, _ = cuda_time_ms(
            lambda: kts.seg_sums(dout, perm, starts, n, B, PB), 5)
        plain_seg_ms, _ = once_ms(
            lambda: kts.segment_sums_plain(dout, rp, rs, n, B, PB))
        # the library calls that sum the same entries by tag: index_add_
        # on the unsorted entries (float atomics), segment_reduce on the
        # sorted ones; each within 1e-3 of the table's largest entry
        ids = keys.long()
        vals = kts.entry_values(dout, torch.arange(ids.numel(),
                                                   device=ids.device),
                                n, B, PB)
        lib_seg_ms, by_add = cuda_time_ms(lambda: torch.zeros(
            (m + 1, PB), device=ids.device).index_add_(0, ids, vals), 5)
        sorted_vals, lengths = vals[rp], rs[1:] - rs[:-1]
        # timed once: it takes 0.28-0.82 s a call on these sets
        red_ms, by_red = once_ms(lambda: torch.segment_reduce(
            sorted_vals, "sum", lengths=lengths, axis=0))
        top = float(seg.abs().max()) if seg.numel() else 0.0
        for lib, got in (("index_add_", by_add), ("segment_reduce", by_red)):
            err = float((got[1:] - seg).abs().max()) if seg.numel() else 0.0
            if not err <= 1e-3 * max(top, 1e-30):
                raise AssertionError(f"{lib} {tag}: {err:.3g} from the "
                                     f"segment sums (largest {top:.3g})")
        del vals, sorted_vals, by_add, by_red
        E = tags.numel()
        tagged = E - int(rs[1])
        # K7's and K8's horizon entries carry de alone (3 of PB columns)
        horizon = int((tags[B] & mask).ne(0).sum()) if tags.shape[0] > B \
            else 0
        values = tagged * PB - horizon * (PB - 3)
        pieces = int(((rs[2:] - rs[1:-1] + kts.SEG_PIECE - 1)
                      // kts.SEG_PIECE).sum())
        out.append(dict(
            tag=tag, sort_ms=sort_ms, plain_sort_ms=plain_sort_ms,
            lib_sort_ms=lib_sort_ms, seg_ms=seg_ms, plain_seg_ms=plain_seg_ms,
            lib_seg_ms=lib_seg_ms, red_ms=red_ms,
            sort_bound=bound_ms(4 * (2 * E + m + 2), 0.0),
            seg_bound=bound_ms(4 * (values + tagged + m + 2 + m * PB),
                               float(values)),
            longest=int((rs[2:] - rs[1:-1]).max()) if m else 0,
            pieces=pieces))
        print(f"tag sums: {tag} ({tagged} tagged, the longest tag "
              f"{out[-1]['longest']} entries, {pieces} pieces of "
              f"{kts.SEG_PIECE}): the card's sort = torch.sort(stable=True)'s "
              f"perm and starts, int32; the split sums = segment_sums_plain "
              f"bit for bit, repeat; sort {sort_ms:.3f} ms (plain "
              f"{plain_sort_ms:.3f}, one torch.sort {lib_sort_ms:.3f}), sums "
              f"{seg_ms:.3f} ms (plain {plain_seg_ms:.1f}), sort + sums "
              f"{sort_ms + seg_ms:.3f} ms against one index_add_ "
              f"{lib_seg_ms:.3f} ms (segment_reduce of the sorted entries "
              f"{red_ms:.3f}); bounds "
              f"{out[-1]['sort_bound'][0]:.4f} ms by "
              f"{out[-1]['sort_bound'][1]} and {out[-1]['seg_bound'][0]:.4f} ms "
              f"by {out[-1]['seg_bound'][1]}", flush=True)
    return out


def check_recorded_step(kmod, seen, what: str, ks=("K1", "K2", "K3")):
    """A train step's own residual forward and cache backward calls, kept by
    `recording`: ks names (forward, residual forward, cache backward), K1,
    K2 and K3 of kernels/wavefront.py or K5, K6 and K7 of
    kernels/bigscene.py (kmod). The residual forward's radiance against the
    forward's on the step's lanes (bit for bit), it and its cache against
    its plain version, the backward on the step's upstream gradient against
    its plain version and against itself (bit for bit) -> (the residual
    forward's, the backward's max |err|)."""
    kf, kr, kb = ks
    tabs, (scfg, so, sd, sseed, ssi, spix), kw, (k2, resf, resi) = \
        seen["trace_lanes"]
    if not kw.get("residual"):
        raise AssertionError(f"the {what} did not run {kr}")
    _, (_, sg, *_), _, grads = seen["bwd_res"]
    if not torch.equal(k2, kmod.trace_lanes(tabs, scfg, so, sd, sseed, ssi,
                                            spix)):
        raise AssertionError(f"{kr}'s radiance is not {kf}'s bit for bit on "
                             f"a {what}'s lanes")
    if not all(torch.equal(a, b) for a, b in zip(
            grads, kmod.bwd_res(tabs, scfg, sg, k2, resf, resi))):
        raise AssertionError(f"{kb}'s gradient does not repeat bit for bit "
                             f"on a {what}")
    ref_l, ref_f, ref_i = kmod.trace_lanes_plain(tabs, scfg, so, sd, sseed,
                                                 ssi, spix, residual=True)
    share, mabs, _ = compare(k2, ref_l, f"{kr}, a {what}")
    cerr = compare_cache(resf, resi, ref_f, ref_i, f"{kr} cache, a {what}")
    gerr = compare_grads(grads, kmod.bwd_res_plain(
        tabs, scfg, sg, ref_l, ref_f, ref_i), f"{kb}, a {what}")
    print(f"{what} vs plain: {so.shape[0]} lanes, depth {scfg.max_depth}, "
          f"{scfg.sampler}/{scfg.nee}/{scfg.shadow}"
          f"{', trainable exponent' if scfg.trainable_exponent else ''}, "
          f"upstream gradient of relmse: {kr} radiance = {kf}'s bit for bit, "
          f"{share:.5f} of lanes outside vs plain (max |err| {mabs:.3g}); "
          f"cache {resf.shape[0]}+{resi.shape[0]} planes within the bound "
          f"(max |err| {cerr:.3g}); {kb} ({len(grads)} tables) within the "
          f"bound (max |err| {gerr:.3g}), repeats bit for bit", flush=True)
    return max(mabs, cerr), gerr


def many_lights(b, n_lights: int, width: int = 24, height: int = 16,
                n_checkers: int = 0, extra_spheres: int = 0):
    """tests/test_torch_cuda.py's many_lights, kept here so that this script
    needs nothing of the tests: a matte floor (or n_checkers quads, each
    with a checker texture of its own) and a glossy back wall lit by a point
    light and n_lights - 1 small sphere lights in a row, extra_spheres
    matte spheres in front of them."""
    A = b._SceneAssembler
    a = A()
    g = a.geo
    if n_checkers:
        k = int(np.ceil(np.sqrt(n_checkers)))
        step = 20.0 / k
        for t in range(n_checkers):
            x0, z0 = -10 + step * (t % k), -10 + step * (t // k)
            x1, z1 = x0 + step, z0 + step
            c = 0.2 + 0.6 * ((np.arange(3) + t) % 3) / 2
            tex = a.add_checker(np.float32(c), np.float32(1.0 - c),
                                scale=(2.0, 2.0))
            a.surface(g.add_rectangle((x0, -2, z1), (x0, -2, z0),
                                      (x1, -2, z0), (x1, -2, z1),
                                      flip_normal=True),
                      A.matte(np.full(3, 0.5, np.float32), texture=tex))
    else:
        a.surface(g.add_rectangle((-10, -2, 10), (-10, -2, -10),
                                  (10, -2, -10), (10, -2, 10),
                                  flip_normal=True),
                  A.matte(np.full(3, 0.5, np.float32)))
    for k in range(extra_spheres):
        c = (-4.5 + 9.0 * k / max(extra_spheres - 1, 1), -1.5, -1.0)
        a.surface(g.add_sphere(c, 0.2),
                  A.matte(np.float32([0.3 + 0.4 * (k % 2), 0.5, 0.4])))
    a.surface(g.add_rectangle((-10, -10, 3), (-10, 10, 3), (10, 10, 3),
                              (10, -10, 3), flip_normal=True),
              A.plastic(np.float32([0.1, 0.1, 0.15]), np.ones(3, np.float32),
                        100.0))
    a.add_light(kind=b.klights.POINT, emit=np.full(3, 5.0, np.float32),
                position=np.float32([0.0, 3.0, -2.0]))
    n_sph = n_lights - 1
    for k in range(n_sph):
        c = (-4.5 + 9.0 * k / max(n_sph - 1, 1), 1.0 + 0.25 * (k % 3), 0.0)
        r = 0.05 + 0.03 * (k % 5)
        emit = np.full(3, 40.0 / (1 + k % 4), np.float32)
        slot = a.add_light(kind=b.klights.AREA_SPHERE, emit=emit,
                           center=np.asarray(c), radius=r)
        a._lights[slot]["surface_handle"] = a.surface(
            g.add_sphere(c, r), A.matte(np.zeros(3, np.float32)),
            emission=emit, light_slot=slot)
    cam = b.kscene.make_camera(position=(0.0, 1.0, -8.0),
                               front=(0.0, -0.2, 1.0), up=(0.0, 1.0, 0.0),
                               fov_degrees=50.0, width=width, height=height)
    return a.build(cam)


def past_the_caps(smi: str) -> dict:
    """Phase 13a: K1-K8 past 32 lights and 64 textures. Returns each
    kernel's launches on this phase's main paths, its max |err| against its
    plain version and its ms at 33 and 64 lights."""
    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff.inverse import make_train_step
    from kytpu_torch.integrator.render import render
    from kytpu_torch.kernels import bigscene as kbs
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.scene import builders

    n = 1 << 20
    errs = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")}
    ms = {}

    def wf_case(scene, cfg, tag, timed):
        """K1-K4 on n jittered lanes of `scene` against their plain
        versions (K1, K2 bit for bit; K3, K4 within the gradient bound, K4
        against K3 within the reference's, each repeating bit for bit);
        -> {kernel: ms} where `timed`."""
        o, d, si, pix = jittered_rays(scene, n, 17)
        tables = kwf.pack_tables(scene, cfg)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(8))
        reps = 3 if timed else 0
        run = (lambda f: cuda_time_ms(f, reps)) if timed else (
            lambda f: (0.0, f()))
        t1, k1 = run(lambda: kwf.trace_lanes(tables, cfg, o, d, 41, si, pix))
        t2, (k2, resf, resi) = run(lambda: kwf.trace_lanes(
            tables, cfg, o, d, 41, si, pix, residual=True))
        t3, k3 = run(lambda: kwf.bwd_res(tables, cfg, g, k2, resf, resi))
        t4, k4 = run(lambda: kwf.bwd_replay(tables, cfg, o, d, 41, si, pix,
                                            g, k1))
        times = {"K1": t1, "K2": t2, "K3": t3, "K4": t4}
        ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 41,
                                                    si, pix, residual=True)
        same_bits(k1, ref_l, f"K1 {tag}")
        same_bits((k2, resf, resi), (ref_l, ref_f, ref_i), f"K2 {tag}")
        _, mabs, _ = compare(k1, ref_l, f"K1 {tag}")
        errs["K1"] = max(errs["K1"], mabs)
        errs["K2"] = max(errs["K2"], mabs)
        if not all(torch.equal(a, b) for a, b in zip(
                kwf.bwd_res(tables, cfg, g, k2, resf, resi), k3)):
            raise AssertionError(f"K3 {tag}: does not repeat bit for bit")
        if not all(torch.equal(a, b) for a, b in zip(kwf.bwd_replay(
                tables, cfg, o, d, 41, si, pix, g, k1), k4)):
            raise AssertionError(f"K4 {tag}: does not repeat bit for bit")
        ref3 = kwf.bwd_res_plain(tables, cfg, g, ref_l, ref_f, ref_i)
        del ref_f, ref_i
        ref4 = kwf.bwd_replay_plain(tables, cfg, o, d, 41, si, pix, g, ref_l)
        e3 = compare_grads(k3, ref3, f"K3 {tag}")
        e4 = compare_grads(k4, ref4, f"K4 {tag}")
        xerr = compare_grads(k4, k3, f"K4 vs K3 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        errs["K3"], errs["K4"] = max(errs["K3"], e3), max(errs["K4"], e4)
        print(f"past the caps: {tag}, {n} lanes, depth {cfg.max_depth}: K1 "
              f"and K2 (radiance, cache {resf.shape[0]}+{resi.shape[0]} "
              f"planes) = plain bit for bit; K3 (route "
              f"{kwf.acc_route(tables, cfg)}, {kwf._row_cols(tables, cfg)} "
              f"columns) and K4 (route {kwf.acc_route(tables, cfg, True)}) "
              f"within the bound (max |err| {e3:.3g}, {e4:.3g}), each repeats "
              f"bit for bit, K4 vs K3 max |diff| {xerr:.3g}"
              + (f"; K1 {t1:.3f} ms, K2 {t2:.3f}, K3 {t3:.3f}, K4 {t4:.3f} "
                 f"on {smi}" if timed else ""), flush=True)
        return times

    def big_case(scene, cfg, tag, timed):
        """K5-K8 on n jittered lanes against their plain versions (the
        bounds of phase 9a) and against cull="off" bit for bit."""
        o, d, si, pix = jittered_rays(scene, n, 19)
        tables = kbs.pack_big_tables(scene, cfg)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(9))
        reps = 3 if timed else 0
        run = (lambda f: cuda_time_ms(f, reps)) if timed else (
            lambda f: (0.0, f()))
        t5, k5 = run(lambda: kbs.trace_lanes(tables, cfg, o, d, 43, si, pix))
        t6, (k6, resf, resi) = run(lambda: kbs.trace_lanes(
            tables, cfg, o, d, 43, si, pix, residual=True))
        t7, k7 = run(lambda: kbs.bwd_res(tables, cfg, g, k6, resf, resi))
        t8, k8 = run(lambda: kbs.bwd_replay(tables, cfg, o, d, 43, si, pix,
                                            g, k5))
        if not torch.equal(k5, k6):
            raise AssertionError(f"K6 {tag}: its radiance is not K5's")
        for nm, f, ref in (
                ("K7", lambda: kbs.bwd_res(tables, cfg, g, k6, resf, resi),
                 k7),
                ("K8", lambda: kbs.bwd_replay(tables, cfg, o, d, 43, si, pix,
                                              g, k5), k8)):
            if not all(torch.equal(a, b) for a, b in zip(f(), ref)):
                raise AssertionError(f"{nm} {tag}: does not repeat bit for "
                                     "bit")
        same_as_cull_off(tables, cfg, (o, d, 43, si, pix), g,
                         (k5, (k6, resf, resi), k8), tag)
        ref_l, ref_f, ref_i = kbs.trace_lanes_plain(tables, cfg, o, d, 43, si,
                                                    pix, residual=True)
        _, mabs, _ = compare(k5, ref_l, f"K5 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K6 cache {tag}")
        e7 = compare_grads(k7, kbs.bwd_res_plain(tables, cfg, g, ref_l, ref_f,
                                                 ref_i), f"K7 {tag}")
        del ref_f, ref_i
        e8 = compare_grads(k8, kbs.sums_plain(tables, cfg, *kbs.bwd_replay_plain(
            tables, cfg, o, d, 43, si, pix, g, k5)), f"K8 {tag}")
        xerr = compare_grads(k8, k7, f"K8 vs K7 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        errs["K5"] = max(errs["K5"], mabs)
        errs["K6"] = max(errs["K6"], mabs, cerr)
        errs["K7"], errs["K8"] = max(errs["K7"], e7), max(errs["K8"], e8)
        wide = kbs._n_cols(tables) > kwf.local_row_cols(
            bool(tables.static["textures"]))
        print(f"past the caps: {tag}, {n} lanes, depth {cfg.max_depth}: K5 "
              f"within the bound (max |err| {mabs:.3g}), K6 = K5 bit for "
              f"bit, its cache within the bound (max |err| {cerr:.3g}); K5, "
              f"K6 and K8 = cull='off' bit for bit; K7 and K8 ("
              f"{kbs._n_cols(tables)} lane columns, "
              f"{'in device memory' if wide else 'local rows'}) within the "
              f"bound (max |err| {e7:.3g}, {e8:.3g}), each repeats bit for "
              f"bit, K8 vs K7 max |diff| {xerr:.3g}"
              + (f"; K5 {t5:.3f} ms, K6 {t6:.3f}, K7 {t7:.3f}, K8 {t8:.3f} on "
                 f"{smi}" if timed else ""), flush=True)
        return {"K5": t5, "K6": t6, "K7": t7, "K8": t8}

    # 13a-i. K1-K4 at 32, 33 and 64 lights (512x512, 1M lanes, depth 3),
    # timed at hash/all/robust
    for L in (32, 33, 64):
        sc = many_lights(builders, L, 512, 512).to("cuda")
        for k, (sampler, nee, shadow) in enumerate((
                ("hash", "all", "robust"), ("random", "single", "parity"))):
            cfg = kwf.KernelConfig(max_depth=3, sampler=sampler, nee=nee,
                                   shadow=shadow)
            t = wf_case(sc, cfg, f"{L} lights ({int(sc.mat_kind.shape[0])} "
                        f"surfaces) {sampler}/{nee}/{shadow}", k == 0)
            if k == 0:
                ms[L] = t
        torch.cuda.empty_cache()
    # 13a-ii. past 64 surfaces with 33 and 64 lights: K5-K8 (and K1-K4 on
    # the row-tagged route at 64 lights, above); timed at hash/robust
    for L, extra in ((33, 40), (64, 0)):
        sc = many_lights(builders, L, 512, 512, extra_spheres=extra).to("cuda")
        for k, (sampler, shadow) in enumerate((("hash", "robust"),
                                               ("random", "parity"))):
            cfg = kwf.KernelConfig(max_depth=3, sampler=sampler, shadow=shadow)
            t = big_case(sc, cfg, f"{L} lights, {int(sc.mat_kind.shape[0])} "
                         f"surfaces, {sampler}/{shadow}", k == 0)
            if k == 0:
                ms.setdefault(L, {}).update(t)
        torch.cuda.empty_cache()
    # the big kernels at 32 lights past 64 surfaces, for the times beside
    sc = many_lights(builders, 32, 512, 512, extra_spheres=40).to("cuda")
    ms[32].update(big_case(sc, kwf.KernelConfig(max_depth=3, sampler="hash",
                                                shadow="robust"),
                           "32 lights, 73 surfaces, hash/robust", True))
    # 13a-iii. 65 checker textures and 33 lights (100 surfaces: K5-K8 with
    # textures, and K1-K4 on the row-tagged route, their rows in device
    # memory)
    sc = many_lights(builders, 33, 512, 512, n_checkers=65).to("cuda")
    for sampler, shadow in (("hash", "robust"), ("sobol", "parity")):
        cfg = kwf.KernelConfig(max_depth=3, sampler=sampler, shadow=shadow)
        tag = f"65 checker textures, 33 lights, {sampler}/{shadow}"
        big_case(sc, cfg, tag, False)
        wf_case(sc, cfg, tag, False)
    torch.cuda.empty_cache()

    # 13a-iv. the main paths past the caps, launches counted: a 64-light
    # frame through render() (K5 past 64 surfaces) and a 33-light one (K1),
    # and train steps on each (K6 + K7, K2 + K3) and on the 65-texture
    # scene's checker colours (K6 + K7 with textures)
    def read():
        return {"K1": kprof.launches("k1"), "K2": kprof.launches("k2"),
                "K3": kprof.launches("k3"), "K4": kprof.launches("k4"),
                "K5": kprof.launches("k5"), "K6": kprof.launches("k6"),
                "K7": kprof.launches("k7"), "K8": kprof.launches("k8"),
                "tag_sort": kprof.launches("tag_sort"),
                "segment_sums": kprof.launches("segment_sums")}

    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for L, extra in ((33, 0), (64, 0)):
        sc = many_lights(builders, L, 256, 256, extra_spheres=extra)
        kprof.reset()
        img = render(sc, spp=16, seed=3, clamp=False)
        torch.cuda.synchronize()
        got = read()
        want = "K5" if int(sc.mat_kind.shape[0]) > 64 else "K1"
        if got[want] == 0 or not bool(torch.isfinite(img).all()) or \
                float(img.mean()) <= 0:
            raise AssertionError(f"{L}-light frame: launches {got}")
        add(got)
        true = sc.to("cuda")
        target = render(true, spp=64, seed=4, clamp=False)
        start = dataclasses.replace(true, mat_diffuse=true.mat_diffuse * 0.4)
        step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                          kernel_sampler="hash")
        kprof.reset()
        losses = [float(step(krng.key(11))) for _ in range(3)]
        torch.cuda.synchronize()
        got = read()
        pair = ("K6", "K7") if want == "K5" else ("K2", "K3")
        if not (got[pair[0]] == 3 and got[pair[1]] == 3) or not all(
                np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{L}-light steps: launches {got}, losses "
                                 f"{losses}")
        add(got)
        print(f"past the caps: main paths at {L} lights "
              f"({int(sc.mat_kind.shape[0])} surfaces): a 256x256 16-spp "
              f"frame through render() ({want}), mean {float(img.mean()):.5f};"
              f" three train steps ({'/'.join(pair)}), loss "
              f"{' -> '.join(f'{x:.5f}' for x in losses)}", flush=True)
    sc = many_lights(builders, 33, 256, 256, n_checkers=65)
    true = sc.to("cuda")
    target = render(true, spp=64, seed=4, clamp=False)
    tx = true.textures
    start = dataclasses.replace(true, textures=dataclasses.replace(
        tx, color_a=tx.color_a * 0.4, color_b=tx.color_b * 0.4))
    step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                      kernel_sampler="hash",
                                      names=("tex_color_a", "tex_color_b"))
    kprof.reset()
    losses = [float(step(krng.key(12))) for _ in range(3)]
    torch.cuda.synchronize()
    got = read()
    if got["K6"] != 3 or got["K7"] != 3 or not all(np.isfinite(losses)):
        raise AssertionError(f"65-texture steps: launches {got}, losses "
                             f"{losses}")
    add(got)
    print(f"past the caps: main path, 65 checker textures and 33 lights "
          f"(100 surfaces): three checker-colour steps (K6/K7), loss "
          f"{' -> '.join(f'{x:.5f}' for x in losses)}", flush=True)
    for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"):
        print(f"past the caps: {k} ms at 32 / 33 / 64 lights: "
              + " / ".join(f"{ms[L][k]:.3f}" for L in (32, 33, 64))
              + f" (K1-K4: many_lights 512x512, 1M lanes, depth 3, hash/all/"
                f"robust, 35 and 66 surfaces at 33 and 64; K5-K8: past 64 "
                f"surfaces, hash/robust) on {smi}", flush=True)
    return {"launches": launches, "errs": errs, "ms": ms}


# 13b's sizes: kytpu's Veach frame and Cornell step, the spheres' frame
DIST_VEACH = (512, 308, 64)
DIST_SPHERES = (1024, 256, 256, 16)
DIST_STEPS = 5


@contextlib.contextmanager
def collective_clock(out: list):
    """While the block runs, every torch.distributed all_reduce and
    all_gather synchronises the card before and after itself and adds its
    host seconds to out[0]: the collectives' share of a (separately
    timed, unclocked) wall."""
    import torch.distributed as dist
    real = {nm: getattr(dist, nm) for nm in ("all_reduce", "all_gather")}

    def clocked(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            out[0] += time.perf_counter() - t0
            return r
        return run

    for nm, fn in real.items():
        setattr(dist, nm, clocked(fn))
    try:
        yield out
    finally:
        for nm, fn in real.items():
            setattr(dist, nm, fn)


def wall_ms(fn, reps: int = 3):
    """(median host ms of reps warmed calls of fn ending in a synchronise,
    fn's last output)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), out


def dist_scenes():
    """13b's scenes and configurations: (Veach, its render kwargs), (the
    spheres, theirs), the Cornell step's (true scene, start, target
    kwargs)."""
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.scene import builders
    vw, vh, vspp = DIST_VEACH
    cfg = kwf.KernelConfig(sampler="hash")
    veach = builders.veach_mis(vw, vh)
    # 8 samples a pass: the passes trace the frame's 64 samples exactly
    vkw = dict(spp=vspp, seed=5, cfg=cfg, rays_per_pass=vw * vh * 8)
    n, sw, sh, sspp = DIST_SPHERES
    spheres = builders.random_spheres(n=n, width=sw, height=sh)
    skw = dict(spp=sspp, seed=6, cfg=dataclasses.replace(cfg, max_depth=3))
    return (veach, vkw), (spheres, skw)


def step_inputs(engine: str):
    """The Cornell step of 13b: (start scene, target, make_train_step
    kwargs): the kernel step at 256x256, 4 spp, depth 3, hash; the jnp one
    at 64x64."""
    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff.inverse import render_once
    from kytpu_torch.integrator.path import PathConfig
    from kytpu_torch.integrator.render import render
    from kytpu_torch.scene import builders
    side = 256 if engine == "cuda" else 64
    true = builders.cornell_box(width=side, height=side).to("cuda")
    start = dataclasses.replace(true, mat_diffuse=true.mat_diffuse * 0.4)
    cfg = PathConfig(max_depth=3)
    if engine == "cuda":
        target = render(true, spp=64, seed=4, clamp=False)
        kw = dict(spp=4, cfg=cfg, kernel_sampler="hash")
    else:
        target = render_once(true, krng.key(7), 2, cfg).detach()
        kw = dict(spp=4, cfg=cfg, engine="jnp")
    return start, target, kw


def run_steps(step, params, n: int = DIST_STEPS):
    """n steps of one key -> (losses, the parameters after them)."""
    from kytpu_torch.core import rng as krng
    losses = [step(krng.key(21)) for _ in range(n)]
    torch.cuda.synchronize()
    return ([float(x) for x in losses],
            {k: v.detach().clone() for k, v in params.items()})


def _dist_rank(rank: int, world: int, init_file: str, out_dir: str,
               shape: tuple) -> None:
    """One of 13b's two gloo ranks on cuda:0: the Veach frame and one
    Cornell kernel step on a `shape` mesh, saved for the parent."""
    from kytpu_torch.diff.inverse import make_train_step
    from kytpu_torch.dist import make_mesh, multihost
    from kytpu_torch.dist.shard import render_sharded_pallas
    multihost.initialize(f"file://{init_file}", world, rank, backend="gloo",
                         device="cuda:0")
    try:
        mesh = make_mesh(shape=shape, device="cuda:0")
        (veach, kw), _ = dist_scenes()
        kw = dict(kw)
        cfg = kw.pop("cfg")

        def frame():
            return render_sharded_pallas(veach, mesh, kernel_cfg=cfg, **kw)

        wall, img = wall_ms(frame)
        coll = [0.0]
        with collective_clock(coll):
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            clocked = time.perf_counter() - t0
        start, target, skw = step_inputs("cuda")
        step, params, _ = make_train_step(start, target, mesh=mesh, **skw)
        t0 = time.perf_counter()
        losses, after = run_steps(step, params, 1)
        step_ms = (time.perf_counter() - t0) * 1e3
        torch.save({"img": img.cpu(), "wall": wall,
                    "share": coll[0] / clocked, "losses": losses,
                    "params": {k: v.cpu() for k, v in after.items()},
                    "step_ms": step_ms},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def distribution(smi: str) -> dict:
    """Phase 13b: the sharded render and train step (kytpu_torch/dist) on
    the card. Returns the kernels' launches on its main paths."""
    import socket
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from kytpu_torch.diff.inverse import make_train_step
    from kytpu_torch.dist import make_mesh, multihost
    from kytpu_torch.dist.shard import render_sharded_pallas
    from kytpu_torch.integrator.render import render
    from kytpu_torch.kernels import bigscene as kbs
    from kytpu_torch.kernels import wavefront as kwf

    launches = {}

    def add():
        got = {"K1": kprof.launches("k1"), "K2": kprof.launches("k2"),
               "K3": kprof.launches("k3"), "K5": kprof.launches("k5"),
               "K6": kprof.launches("k6"), "K7": kprof.launches("k7")}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return got

    (veach, vkw), (spheres, skw) = dist_scenes()
    veach, spheres = veach.to("cuda"), spheres.to("cuda")
    # 13b-i. a world-size-1 NCCL group, a 1x1 mesh
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    multihost.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        mesh = make_mesh(shape=(1, 1))
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"the card's group runs {backend}")
        rows = []
        for what, sc, kw in (("veach 512x308, 64 spp (K1)", veach, vkw),
                             ("random_spheres(1024) 256x256, 16 spp (K5)",
                              spheres, skw)):
            kw = dict(kw)
            cfg = kw.pop("cfg")
            one_ms, ref = wall_ms(lambda: render(sc, clamp=False, cfg=cfg,
                                                 **kw))
            kprof.reset()
            img = render_sharded_pallas(sc, mesh, kernel_cfg=cfg, clamp=False,
                                        **kw)
            torch.cuda.synchronize()
            got = add()
            if not torch.equal(img, ref):
                raise AssertionError(f"{what}: the 1x1 mesh's frame is not "
                                     f"render()'s bit for bit")
            k = "K5" if "K5" in what else "K1"
            if got[k] == 0:
                raise AssertionError(f"{what}: {k} launched no time")
            sh_ms, _ = wall_ms(lambda: render_sharded_pallas(
                sc, mesh, kernel_cfg=cfg, clamp=False, **kw))
            coll = [0.0]
            with collective_clock(coll):
                t0 = time.perf_counter()
                render_sharded_pallas(sc, mesh, kernel_cfg=cfg, clamp=False,
                                      **kw)
                torch.cuda.synchronize()
                clocked = time.perf_counter() - t0
            rows.append(f"{what}: {sh_ms:.3f} ms on the 1x1 NCCL mesh "
                        f"against {one_ms:.3f} ms through render(), the "
                        f"frame render()'s bit for bit; the collectives "
                        f"{coll[0] / clocked:.4f} of a clocked frame")
        for r in rows:
            print(f"distribution: {r}; on {smi}", flush=True)
        for engine in ("cuda", "jnp"):
            start, target, kw = step_inputs(engine)
            runs = []
            for _ in range(2):   # does the unsharded step repeat its bits?
                s_u, p_u, _ = make_train_step(start, target, **kw)
                t0 = time.perf_counter()
                runs.append(run_steps(s_u, p_u))
                one_ms = (time.perf_counter() - t0) * 1e3 / DIST_STEPS
            (ref_l, ref_p), (_, again_p) = runs
            repeats = all(torch.equal(again_p[k], ref_p[k]) for k in ref_p)
            s_m, p_m, _ = make_train_step(start, target, mesh=mesh, **kw)
            kprof.reset()
            t0 = time.perf_counter()
            got_l, got_p = run_steps(s_m, p_m)
            ms = (time.perf_counter() - t0) * 1e3 / DIST_STEPS
            got = add()
            same = got_l == ref_l and all(torch.equal(got_p[k], ref_p[k])
                                          for k in ref_p)
            perr = max(float((got_p[k] - ref_p[k]).abs().max())
                       for k in ref_p)
            # the kernel step repeats its bits, so its 1x1 mesh must give
            # them; the jnp step's autograd adds with atomics on the card
            # (its index backward), so there kytpu's bounds hold it
            if (repeats and not same) or not np.allclose(
                    got_l, ref_l, rtol=1e-5, atol=0) or perr > 1e-5:
                raise AssertionError(f"{engine} step: the 1x1 mesh's steps "
                                     f"are not the unsharded ones: {got_l} "
                                     f"against {ref_l}, parameters {perr:.3g}"
                                     f" apart (the unsharded step repeats "
                                     f"its bits: {repeats})")
            if engine == "cuda" and (got["K2"] != DIST_STEPS
                                     or got["K3"] != DIST_STEPS):
                raise AssertionError(f"the sharded kernel step launched "
                                     f"{got}")
            if not got_l[-1] < got_l[0]:
                raise AssertionError(f"{engine} step: the loss did not fall "
                                     f"{got_l}")
            what = ("Cornell 256x256, 4 spp, depth 3, hash" if engine == "cuda"
                    else "Cornell 64x64, 4 spp, depth 3")
            print(f"distribution: {engine} step on the 1x1 NCCL mesh "
                  f"({what}): {DIST_STEPS} steps "
                  + ("= the unsharded steps bit for bit" if same else
                     f"within rtol 1e-5 (loss) and atol 1e-5 (parameters, "
                     f"max |diff| {perr:.3g}) of the unsharded steps, which "
                     f"{'repeat' if repeats else 'do not repeat'} their own "
                     f"bits")
                  + f", loss {' -> '.join(f'{x:.5f}' for x in got_l)}, "
                  f"{ms:.3f} ms a step against {one_ms:.3f} unsharded; on "
                  f"{smi}", flush=True)
    finally:
        dist.destroy_process_group()

    # 13b-ii. two gloo ranks on cuda:0, meshes (2, 1) and (1, 2), against
    # the one-rank frame and one unsharded kernel step (kytpu's bounds)
    vkw1 = dict(vkw)
    cfg = vkw1.pop("cfg")
    one_ms, one = wall_ms(lambda: render(veach, cfg=cfg, **vkw1))
    one = one.cpu()
    start, target, kw = step_inputs("cuda")
    s_u, p_u, _ = make_train_step(start, target, **kw)
    ref_l, ref_p = run_steps(s_u, p_u, 1)
    for shape in ((2, 1), (1, 2)):
        with tempfile.TemporaryDirectory() as d:
            mp.start_processes(_dist_rank, args=(2, os.path.join(d, "init"),
                                                 d, shape),
                               nprocs=2, join=True, start_method="spawn")
            res = [torch.load(os.path.join(d, f"rank{r}.pt"))
                   for r in range(2)]
        errs = []
        for r, x in enumerate(res):
            err = float((x["img"] - one).abs().max())
            perr = max(float((x["params"][k] - ref_p[k].cpu()).abs().max())
                       for k in ref_p)
            errs.append((err, perr))
            if err > 2e-5 or perr > 1e-5 or not np.isclose(
                    x["losses"][0], ref_l[0], rtol=1e-5, atol=0):
                raise AssertionError(
                    f"{shape} mesh rank {r}: the Veach frame {err:.3g} from "
                    f"the one-rank frame (2e-5), the step's parameters "
                    f"{perr:.3g} from the unsharded step's (1e-5), loss "
                    f"{x['losses'][0]} against {ref_l[0]} (rtol 1e-5)")
        if not all(torch.equal(res[0]["params"][k], res[1]["params"][k])
                   for k in ref_p):
            raise AssertionError(f"{shape} mesh: the ranks' parameters differ")
        print(f"distribution: two gloo ranks on cuda:0, a {shape} mesh: the "
              f"Veach 512x308 64-spp frame (K1) within 2e-5 of the one-rank "
              f"frame (max |diff| {max(e for e, _ in errs):.3g}), "
              f"{res[0]['wall']:.3f} and {res[1]['wall']:.3f} ms a rank "
              f"against {one_ms:.3f} ms on one rank, the collectives "
              f"{res[0]['share']:.4f} and {res[1]['share']:.4f} of a clocked "
              f"frame; a Cornell 256x256 kernel step within rtol 1e-5 "
              f"(loss) and atol 1e-5 (parameters, max |diff| "
              f"{max(p for _, p in errs):.3g}) of the unsharded step, "
              f"{res[0]['step_ms']:.3f} ms on rank 0 (its first, with the "
              f"tracer's set-up), both ranks the same parameters; on {smi}",
              flush=True)
    return {"launches": launches}


def jnp_engines() -> None:
    """Phase 12: kytpu's default render path, the jnp engines
    (integrator/path.py, integrator/fast.py, plain torch code, no kernel of
    their own) and their autograd train step, on the card at full width.
    Each step prints one line; any failed check raises."""
    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff import inverse as kinv
    from kytpu_torch.integrator.fast import FastConfig
    from kytpu_torch.integrator.path import PathConfig
    from kytpu_torch.integrator.render import (render, render_aov,
                                               render_region, trace_lanes)
    from kytpu_torch.scene import builders

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def peak_of(fn):
        """(fn's output, ms, peak device bytes while it ran)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, out = timed(fn)
        return out, ms, torch.cuda.max_memory_allocated()

    def finite_image(img, shape, what):
        a = img.detach().cpu().numpy()
        if a.shape != shape or not np.isfinite(a).all() or (a < 0).any() \
                or a.mean() <= 0:
            raise AssertionError(f"{what}: shape {a.shape}, not finite, "
                                 "negative or black")
        return a

    # (a) kytpu's README example (README.md:80-91) at 16 of its 64 spp
    cornell = builders.cornell_box(width=256, height=256)
    cfg_a = PathConfig(strategy="both_mis")

    def frame_a():
        return render(cornell, spp=16, seed=1234, cfg=cfg_a, engine="jnp",
                      clamp=False)

    img, first, peak = peak_of(frame_a)
    a = finite_image(img, (256, 256, 3), "README frame")
    walls = [timed(frame_a)[0] for _ in range(3)]
    wall = float(np.median(walls))
    busy, _, n_k = device_profile(frame_a, {})
    print(f"jnp engines (a): kytpu's README example, Cornell 256x256 "
          f"PathConfig(strategy='both_mis'), depth 5, 16 of its 64 spp (one "
          f"pass of {256 * 256 * 16} lanes) through render(engine='jnp'): "
          f"first frame {first:.1f} ms, wall {wall:.1f} ms (median of 3 "
          f"warmed frames: {min(walls):.1f}-{max(walls):.1f}), device busy "
          f"{busy:.1f} ms in {n_k} kernels (idle share "
          f"{1 - busy / wall:.3f}), peak memory {peak} B; mean "
          f"{a.mean():.5f}", flush=True)

    # (b) the fast engine against K1 (kytpu's tests/test_kernel.py:175-188,
    # there at 16x16: both clamped, each downsampled to 4x4)
    ms_fast, fast64 = timed(lambda: render(cornell, spp=64, seed=5,
                                           cfg=FastConfig(), engine="jnp"))
    ms_k1, k164 = timed(lambda: render(cornell, spp=64, seed=3,
                                       engine="cuda"))
    f64 = finite_image(fast64, (256, 256, 3), "fast 64-spp frame")
    k64 = finite_image(k164, (256, 256, 3), "K1 64-spp frame")

    def down(x, n):
        return x.reshape(n, 256 // n, n, 256 // n, 3).mean(axis=(1, 3))

    err4 = float(np.abs(down(f64, 4) - down(k64, 4)).mean())
    err64 = float(np.abs(down(f64, 64) - down(k64, 64)).mean())
    if not err4 < 0.03:
        raise AssertionError(f"fast engine vs K1: {err4} >= 0.03")
    print(f"jnp engines (b): Cornell 256x256, 64 spp, depth 5, clamped: the "
          f"fast engine ({ms_fast:.1f} ms, 4 passes) against K1 through "
          f"render(engine='cuda') ({ms_k1:.1f} ms): mean |difference| of the "
          f"4x4-downsampled frames {err4:.5f} (< 0.03), of 64x64 "
          f"downsamplings {err64:.5f}", flush=True)

    # (c) the card against the CPU on a 32x32 Veach region, lane by lane
    veach = builders.veach_mis(512, 308)
    cfg_c = PathConfig(max_depth=3)
    x0, y0, side = 240, 138, 32
    lanes = {}
    for dev in ("cuda", "cpu"):
        sc = veach.to(dev)
        ys, xs = torch.meshgrid(torch.arange(y0, y0 + side, device=dev),
                                torch.arange(x0, x0 + side, device=dev),
                                indexing="ij")
        pid = (ys * 512 + xs).reshape(-1).repeat(2)
        sid = torch.arange(2, device=dev).repeat_interleave(side * side)
        lanes[dev] = trace_lanes(sc, krng.key(9, dev), (pid % 512).float(),
                                 (pid // 512).float(), pid, sid, cfg_c,
                                 "path", None)
    share, mabs, _ = compare(lanes["cuda"], lanes["cpu"],
                             "jnp path on the card vs the CPU")
    reg = {dev: render_region(veach, x0, y0, x0 + side, y0 + side, spp=2,
                              seed=9, cfg=cfg_c, clamp=False, device=dev)
           for dev in ("cuda", "cpu")}
    rshare, rmabs, _ = compare(reg["cuda"].reshape(-1, 3),
                               reg["cpu"].reshape(-1, 3),
                               "render_region on the card vs the CPU")
    print(f"jnp engines (c): Veach 32x32 region at ({x0}, {y0}), path "
          f"both_mis, depth 3, 2 spp: the card against the CPU, "
          f"{lanes['cuda'].shape[0]} lanes, {share:.5f} outside rtol 1e-3/"
          f"atol 1e-4 (max |err| {mabs:.3g}); render_region's pixels "
          f"{rshare:.5f} outside (max |err| {rmabs:.3g})", flush=True)

    # (d) rays a second (benchmarks/run.py:185-190, :99-131)
    n_v = 512 * 308 * 16
    render(veach, spp=16, seed=2, cfg=FastConfig(), engine="jnp")
    img, ms_v, peak_v = peak_of(lambda: render(veach, spp=16, seed=3,
                                               cfg=FastConfig(),
                                               engine="jnp"))
    finite_image(img, (308, 512, 3), "Veach fast frame")
    render_aov(veach, "normal", spp=4, seed=1)
    ms_aov, aov = timed(lambda: render_aov(veach, "normal", spp=4, seed=2))
    if not torch.isfinite(aov).all() or aov.abs().max() > 1.0 + 1e-6:
        raise AssertionError("AOV normal frame: not finite unit normals")
    spheres = builders.random_spheres(n=1024, width=256, height=256).to(
        "cuda")
    n_s = 1 << 20
    pid = torch.arange(n_s, device="cuda") % (256 * 256)
    sid = torch.zeros_like(pid)

    def spheres_fast(i):
        return trace_lanes(spheres, krng.fold_in(krng.key(1, "cuda"), i),
                           (pid % 256).float(), (pid // 256).float(), pid,
                           sid, FastConfig(max_depth=3), "fast", None)

    spheres_fast(0)
    out, ms_s, peak_s = peak_of(lambda: spheres_fast(1))
    if not torch.isfinite(out).all() or out.mean() <= 0:
        raise AssertionError("spheres fast lanes: not finite or black")
    print(f"jnp engines (d): Veach 512x308 fast, 16 spp, depth 5, "
          f"{n_v / ms_v / 1e3:.2f} Mrays/s ({ms_v:.1f} ms, peak {peak_v} B); "
          f"the AOV normal frame at 4 spp {512 * 308 * 4 / ms_aov / 1e3:.2f} "
          f"Mrays/s ({ms_aov:.1f} ms); random_spheres(1024) "
          f"({spheres.geometry.n_surfaces} surfaces) fast, {n_s} lanes, "
          f"depth 3, {n_s / ms_s / 1e3:.2f} Mrays/s ({ms_s:.1f} ms, peak "
          f"{peak_s} B)", flush=True)
    del out, spheres

    # (e) five autograd train steps (benchmarks/run.py:192-207's cell,
    # through engine="jnp")
    scene_i = builders.cornell_box(width=64, height=64).to("cuda")
    cfg_i = PathConfig(max_depth=3)
    target = kinv.render_once(scene_i, krng.key(7), 2, cfg_i).detach()
    start = dataclasses.replace(scene_i,
                                mat_diffuse=scene_i.mat_diffuse * 0.4)
    step, params, _ = kinv.make_train_step(start, target, spp=4, cfg=cfg_i,
                                           engine="jnp")
    key = krng.key(0)
    steps, losses = [], []
    for i in range(5):
        ms, loss = timed(lambda: step(krng.fold_in(key, i)))
        steps.append(ms)
        losses.append(float(loss))
    if not np.isfinite(losses).all() or not all(
            torch.isfinite(p).all() for p in params.values()):
        raise AssertionError(f"jnp train steps: loss {losses} or a "
                             "parameter not finite")
    busy_s, _, n_ks = device_profile(lambda: step(krng.fold_in(key, 5)), {})
    step_ms = float(np.median(steps[1:]))
    print(f"jnp engines (e): make_train_step(engine='jnp'), Cornell 64x64, "
          f"4 spp, depth 3, target render_once(2 spp, key 7), diffuse x 0.4 "
          f"at the start: {step_ms:.1f} ms a step (median of steps 2-5; the "
          f"first {steps[0]:.1f}), one step's device busy {busy_s:.1f} ms in "
          f"{n_ks} kernels (idle share {1 - busy_s / step_ms:.3f}); losses "
          + ", ".join(f"{v:.5f}" for v in losses), flush=True)


# phase 14's sizes: the grid against the sweep (14c)
GRID_SPHERES, GRID_RAYS, GRID_FRAME = 1024, 1 << 20, 256
# the runs of 14a, in order: (subcommand, its arguments past the
# defaults); the three strategy-matrix subcommands last. The trimesh run on
# the jnp engine takes a quarter of its default 24 spp: at 24 it took 68.5
# s, the longest run of chip_smoke (PERF.md section 4)
CLI_RUNS = [("single", ["--engine", "pallas"]), ("single", []),
            ("trimesh", ["--engine", "pallas"]), ("trimesh", ["--spp", "6"]),
            ("spheres", []), ("mis", []), ("debug", []), ("textured", []),
            ("integrators", []), ("strategies", []), ("scenes", [])]


def entry_points(smi: str) -> dict:
    """Phase 14: the entry points users start from (kytpu_torch/cli, film,
    native, scene/accel.py) on the card. Returns the kernels' launches on
    its main path (the render CLI's K1 and K5) and its numbers."""
    import contextlib as ctx
    import io as sio
    import tempfile

    from kytpu_torch.cli import inverse as cinv
    from kytpu_torch.cli import render as cli
    from kytpu_torch.film import io as fio
    from kytpu_torch.film.film import to_numpy
    from kytpu_torch.integrator.fast import FastConfig
    from kytpu_torch.integrator.render import render
    from kytpu_torch.kernels import bigscene as kbs
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.native import build as nbuild
    from kytpu_torch.native import film_io as nfilm
    from kytpu_torch.scene import accel as kaccel
    from kytpu_torch.scene import builders
    from kytpu_torch.scene import shapes as kshapes
    from kytpu_torch.utils.checks import validate_radiance

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    tmp = tempfile.TemporaryDirectory()
    out = {}
    # 14a. the render CLI at each subcommand's default size, launches
    # counted
    kprof.reset("k1", "k5")
    t_phase = time.perf_counter()
    images, passes = {}, {}
    for cmd, extra in CLI_RUNS:
        tag = " ".join([cmd] + extra)
        path = os.path.join(tmp.name, f"{cmd}{len(images)}.bmp")
        text = sio.StringIO()
        with ctx.redirect_stdout(text), recording(kwf) as k1_seen, \
                recording(kbs) as k5_seen:
            ms, img = sync_ms(lambda: cli.main([cmd, *extra, "--out",
                                                path]))
        # the last pass of each kernel the run launched, kept for 14a's
        # check against the plain versions
        passes[tag] = {k: seen["trace_lanes"] for k, seen in
                       (("K1", k1_seen), ("K5", k5_seen))
                       if "trace_lanes" in seen}
        validate_radiance(img, tag)
        size0, spp0 = cli.DEFAULTS[cmd]
        if "--spp" in extra:
            spp0 = int(extra[extra.index("--spp") + 1])
        said = " | ".join(ln for ln in text.getvalue().splitlines()
                          if not ln.startswith("wrote"))
        print(f"entry points: cli.render {tag} ({size0}, {spp0} spp): "
              f"{ms:.1f} ms wall, {os.path.getsize(path)} B to "
              f"{os.path.basename(path)}, image {tuple(img.shape)} finite "
              f"and >= 0; it said: {said}", flush=True)
        images[tag] = img
    phase_s = time.perf_counter() - t_phase
    launches = {"K1": kprof.launches("k1"), "K5": kprof.launches("k5")}
    if launches["K1"] == 0 or launches["K5"] == 0:
        raise AssertionError(f"the render CLI launched K1 and K5 "
                             f"{launches} times")
    args = cli.parser().parse_args(["single", "--engine", "pallas"])
    ref = render(cli.single_scene(args.size), spp=args.spp, seed=args.seed,
                 cfg=cli.single_config(args), engine="cuda")
    same_bits(images["single --engine pallas"], ref,
              "single --engine pallas against render(engine='cuda')")
    print(f"entry points: the render CLI's {len(CLI_RUNS)} runs in "
          f"{phase_s:.1f} s, launches K1 {launches['K1']}, K5 "
          f"{launches['K5']}; single --engine pallas = render(engine="
          f"'cuda') bit for bit; on {smi}", flush=True)
    out["cli_s"] = phase_s
    # K1 and K5 against their plain versions on a pass of the CLI's own:
    # the tables, lanes and seeds the pallas runs gave them
    kernel_errs = {}
    for tag, k, kmod in (("single --engine pallas", "K1", kwf),
                         ("trimesh --engine pallas", "K5", kbs)):
        if k not in passes[tag]:
            raise AssertionError(f"cli.render {tag} did not launch {k}")
        tabs, (kcfg, *lanes), kw, got = passes[tag][k]
        p_ms, ref = once_ms(lambda: kmod.trace_lanes_plain(tabs, kcfg, *lanes,
                                                           **kw))
        share, kernel_errs[k], _ = compare(got, ref,
                                           f"{k} on cli.render {tag}")
        print(f"entry points: {k} vs plain on a pass of cli.render {tag}: "
              f"{got.shape[0]} lanes, depth {kcfg.max_depth}, "
              f"{kcfg.sampler} sampler, {share:.5f} of lanes outside the "
              f"bound (max |err| {kernel_errs[k]:.3g}); the plain version "
              f"{p_ms:.1f} ms", flush=True)
        del ref
    passes.clear()

    # 14b. the inverse CLI at its defaults, albedo and texture modes
    for mode in ("albedo", "texture"):
        text = sio.StringIO()
        with ctx.redirect_stdout(text):
            res = cinv.main(["--mode", mode])
        steps = len(res["losses"])
        ms = res["timer"].phases["optimize"] / steps * 1e3
        errs = [ln for ln in text.getvalue().splitlines()
                if "mean abs error" in ln]
        if not np.isfinite(res["losses"]).all() or not errs:
            raise AssertionError(f"inverse {mode}: losses {res['losses']}")
        print(f"entry points: cli.inverse --mode {mode} (32x32, 4 spp, "
              f"{steps} steps, depth 3): {ms:.2f} ms a step, loss "
              f"{res['losses'][0]:.6f} at step 0, {res['losses'][-1]:.6f} "
              f"at step {steps - 1}; {'; '.join(errs)}", flush=True)
        out[f"inverse_{mode}_ms"] = ms

    # 14c. the grid against the sweep, random_spheres(1024): pixel-centre
    # rays and random rays through the scene's box
    sc = builders.random_spheres(GRID_SPHERES, GRID_FRAME, GRID_FRAME,
                                 accel="grid").to("cuda")
    geom, grid = sc.geometry, sc.accel
    rng = np.random.default_rng(61)
    half = float(sc.world_radius)
    o_r = torch.from_numpy(rng.uniform(-half, half, (GRID_RAYS, 3)).astype(
        np.float32)).cuda()
    d_r = torch.from_numpy(rng.normal(size=(GRID_RAYS, 3)).astype(
        np.float32)).cuda()
    d_r = d_r / d_r.norm(dim=1, keepdim=True)
    o_c, d_c = pixel_centre_rays(sc, GRID_RAYS)
    inf = torch.full((GRID_RAYS,), float("inf"), device="cuda")
    for rays, (o, d) in (("pixel-centre", (o_c, d_c)),
                         ("random", (o_r, d_r))):
        g_ms, (gt, gs, gh, steps) = cuda_time_ms(
            lambda: kaccel.traverse(grid, geom, o, d, inf, True), 3)
        s_ms, (st, ss, sv) = cuda_time_ms(
            lambda: kshapes.closest_hit(geom, o, d, inf), 3)
        gv = torch.isfinite(gt)
        if not torch.equal(gv, sv):
            raise AssertionError(f"grid {rays}: valid differs on "
                                 f"{int((gv != sv).sum())} rays")
        if not torch.allclose(gt[sv], st[sv], rtol=1e-5, atol=0):
            raise AssertionError(f"grid {rays}: t beyond rtol 1e-5")
        same = float((gs[sv] == ss[sv]).float().mean())
        if same <= 0.999:
            raise AssertionError(f"grid {rays}: rows equal on {same}")
        shares = []
        if rays == "pixel-centre":
            # from the camera no ray reaches the grid by t 0.5 or 3: the
            # any-hit rays start where each ray enters the grid's box
            t_in, _, meets = kaccel._enter_grid(grid, o, d)
            o = torch.where(meets[:, None], o + t_in[:, None] * d, o)
        for tm in (0.5, 3.0, float("inf")):
            tmax = torch.full((GRID_RAYS,), tm, device="cuda")
            a_ms, a = cuda_time_ms(
                lambda: kaccel.traverse(grid, geom, o, d, tmax, False), 1)
            sa_ms, b = cuda_time_ms(
                lambda: kshapes.any_hit(geom, o, d, tmax), 1)
            share = float((a[2] == b).float().mean())
            if share <= 0.999 or a[3] == 0:
                raise AssertionError(f"grid {rays}: any-hit equal on {share} "
                                     f"at tmax {tm}, {a[3]} DDA steps")
            shares.append(f"tmax {tm}: {share:.6f} equal, grid {a_ms:.3f} "
                          f"ms ({a[3]} DDA steps), sweep {sa_ms:.3f} ms")
        print(f"entry points: grid vs sweep, random_spheres({GRID_SPHERES})"
              f" ({geom.n_surfaces} surfaces, grid {grid.dims}, "
              f"{grid.cell_sp.shape[1]} sphere slots a cell), {GRID_RAYS} "
              f"{rays} rays: closest hit grid {g_ms:.3f} ms = "
              f"{GRID_RAYS / g_ms / 1e3:.2f} Mrays/s ({steps} DDA steps), "
              f"sweep {s_ms:.3f} ms = {GRID_RAYS / s_ms / 1e3:.2f} Mrays/s; "
              f"valid equal, t within rtol 1e-5, rows equal on {same:.6f} "
              f"of hits; any hit: {'; '.join(shares)}; on {smi}", flush=True)
        out[f"grid_{rays}"] = (GRID_RAYS / g_ms / 1e3,
                               GRID_RAYS / s_ms / 1e3, steps)
    del o_r, d_r, o_c, d_c
    fcfg = FastConfig(max_depth=3)
    sweep_sc = builders.random_spheres(GRID_SPHERES, GRID_FRAME, GRID_FRAME)
    g_ms, g_img = sync_ms(lambda: render(sc, spp=4, cfg=fcfg, engine="jnp",
                                         clamp=False))
    s_ms, s_img = sync_ms(lambda: render(sweep_sc, spp=4, cfg=fcfg,
                                         engine="jnp", clamp=False))
    validate_radiance(g_img, "grid frame")
    close = float(torch.isclose(g_img, s_img, rtol=0, atol=1e-4)
                  .float().mean())
    if close <= 0.999:
        raise AssertionError(f"grid frame: {close} of values within 1e-4 "
                             "of the sweep's")
    print(f"entry points: a {GRID_FRAME}x{GRID_FRAME} fast-mode frame of "
          f"random_spheres({GRID_SPHERES}), 4 spp, depth 3: grid "
          f"{g_ms:.1f} ms, sweep {s_ms:.1f} ms (first calls, each "
          f"synchronised); {close:.6f} of values within atol 1e-4; on {smi}",
          flush=True)
    out["grid_frame_ms"], out["sweep_frame_ms"] = g_ms, s_ms
    del g_img, s_img

    # 14d. the native encoder, built into the phase's temporary directory
    # (the checkout's kytpu_torch/_build/ stays as it was), against numpy's
    # bytes and time on the single frame
    t0 = time.perf_counter()
    lib = nbuild.build(verbose=False, out_dir=tmp.name)
    build_s = time.perf_counter() - t0
    enc = nfilm.load(lib)
    frame = images["single --engine pallas"]
    saved = fio._native
    walls = {}
    try:
        for ext in ("bmp", "hdr"):
            for which, native in (("numpy", None), ("native", enc)):
                fio._native = native
                path = os.path.join(tmp.name, f"{which}.{ext}")
                # write_image writes BMP through numpy; the encoder's BMP
                # is timed by itself
                write = (lambda p, im: enc.write_bmp(p, to_numpy(im))) if (
                    ext, which) == ("bmp", "native") else fio.write_image
                ts = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    write(path, frame)
                    ts.append((time.perf_counter() - t0) * 1e3)
                walls[ext, which] = (float(np.median(ts)),
                                     open(path, "rb").read())
            if walls[ext, "numpy"][1] != walls[ext, "native"][1]:
                raise AssertionError(f"native {ext}: not numpy's bytes")
    finally:
        fio._native = saved
    print(f"entry points: the native encoder built in {build_s:.2f} s; its "
          f"BMP and HDR of the {frame.shape[1]}x{frame.shape[0]} single "
          "frame = numpy's bytes; median of 5, the frame on the card: "
          f"write_image's BMP (numpy) {walls['bmp', 'numpy'][0]:.2f} ms, the "
          f"encoder's write_bmp (not dispatched) "
          f"{walls['bmp', 'native'][0]:.2f} ms; write_image's HDR numpy "
          f"{walls['hdr', 'numpy'][0]:.2f} ms, native "
          f"{walls['hdr', 'native'][0]:.2f} ms; on {smi}", flush=True)
    out["write_ms"] = {f"{ext} {w}": v[0] for (ext, w), v in walls.items()}
    tmp.cleanup()
    out["launches"], out["errs"] = launches, kernel_errs
    return out


BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
# nanopt on the card against the CPU (64x64, 4 spp): the means within
# 1e-3, 99% of pixels within 2e-2 (a last-bit tie sends a path another way)
NANO_MEAN, NANO_PIX, NANO_SHARE = 1e-3, 2e-2, 0.99
PARITY_SIZE, PARITY_SPP = 1024, 4


def last_entry_points(smi: str, fb_ms: float) -> dict:
    """Phase 15: kytpu's last entry points on the card: `python -m
    kytpu_torch.bench` (K2 + K3) as a user runs it, then in-process with
    its launches counted, its replay rate (K1 + K4) and the jnp fast
    engine's; nanopt on the card against the CPU; the parity tools' half
    that needs no reference binary. fb_ms: phase 6's residual fwd+bwd of
    the same 4M lanes. Returns the kernels' launches on its main paths."""
    import contextlib as ctx
    import io as sio
    import tempfile

    from kytpu_torch import bench
    from kytpu_torch.examples import nanopt
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.scene import builders
    from kytpu_torch.tools import compare_reference, parity_ci

    def counts():
        return tuple(map(kprof.launches, ("k1", "k2", "k3", "k4")))

    def reset():
        kprof.reset("k1", "k2", "k3", "k4")

    # 15a. the headline as a user runs it, in its own process
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "kytpu_torch.bench"],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    bench_s = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    if res.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"python -m kytpu_torch.bench: exit "
                             f"{res.returncode}, {len(lines)} lines; "
                             f"{res.stderr[-2000:]}")
    rec = json.loads(lines[0])
    metric = "veach_mis_fwd_bwd_rays_per_s_per_chip[cuda_residual]"
    if list(rec) != BENCH_KEYS or rec["metric"] != metric or \
            not rec["value"] > 0 or rec["unit"] != "rays/s":
        raise AssertionError(f"python -m kytpu_torch.bench printed {rec}")
    events = bench.LANES / (fb_ms / 1e3)
    ratio = rec["value"] / events
    print(f"bench: python -m kytpu_torch.bench ({bench_s:.1f} s) printed "
          f"{lines[0]}; phase 6's residual fwd+bwd {fb_ms:.3f} ms gives "
          f"{bench.LANES} / {fb_ms:.3f} ms = {events:.1f} rays/s, bench "
          f"{ratio:.4f}x that; on {smi}", flush=True)
    if not 0.8 <= ratio <= 1.25:
        raise AssertionError(f"bench's rate is {ratio:.4f}x phase 6's")

    # 15b. the same entry in-process, launches counted: K2 and K3 only
    veach = builders.veach_mis(width=bench.W, height=bench.H)
    runs = 1 + bench.SMALL[0] + bench.BIG[0]
    reset()
    with ctx.redirect_stdout(sio.StringIO()) as buf:
        rec_in = bench.main()
    torch.cuda.synchronize()
    res_launches = counts()
    if res_launches != (0, runs, runs, 0) or \
            list(json.loads(buf.getvalue())) != BENCH_KEYS:
        raise AssertionError(f"bench.main() launched K1/K2/K3/K4 "
                             f"{res_launches} (want (0, {runs}, {runs}, 0))"
                             f" or printed {buf.getvalue()!r}")

    # 15c. the replay rate (K1 + K4) and the jnp fast engine's
    reset()
    replay_rate, _ = bench._bench_kernel(veach, backward="replay")
    torch.cuda.synchronize()
    replay_launches = counts()
    if replay_launches != (runs, 0, 0, runs):
        raise AssertionError(f"the replay bench launched K1/K2/K3/K4 "
                             f"{replay_launches}")
    jnp_lanes = 1 << 20
    torch.cuda.reset_peak_memory_stats()
    reset()
    jnp_rate, _ = bench._bench_jnp(veach, lanes=jnp_lanes)
    torch.cuda.synchronize()
    if counts() != (0, 0, 0, 0):
        raise AssertionError(f"the jnp bench launched kernels {counts()}")
    jnp_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"bench: Veach 512x308, depth 5, fwd+bwd, marginal over "
          f"{bench.BIG[0] - bench.SMALL[0]} launches: residual (K2 + K3, "
          f"in-process, K2/K3 launched {runs} times each) "
          f"{rec_in['value']:.1f} rays/s, replay (K1 + K4) "
          f"{replay_rate:.1f} rays/s ({bench.LANES} lanes); the jnp fast "
          f"engine (torch autograd, no kernel) {jnp_rate:.1f} rays/s at "
          f"{jnp_lanes} lanes over 6 launches, peak {jnp_peak:.3f} GB; on "
          f"{smi}", flush=True)

    # 15d. nanopt: the example on the card, and the card against the CPU
    tmp = tempfile.TemporaryDirectory()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ctx.redirect_stdout(sio.StringIO()):
        img = nanopt.main(16, device="cuda",
                          out=os.path.join(tmp.name, "nanopt.ppm"))
    nano_s = time.perf_counter() - t0
    if img.shape != (256, 256, 3) or not np.isfinite(img).all() or \
            not img.mean() > 0:
        raise AssertionError(f"nanopt 256x256: {img.shape}, {img.mean()}")
    with ctx.redirect_stdout(sio.StringIO()):
        on_card = nanopt.main(4, 64, 64, device="cuda",
                              out=os.path.join(tmp.name, "card.ppm"))
        on_cpu = nanopt.main(4, 64, 64, device="cpu",
                             out=os.path.join(tmp.name, "cpu.ppm"))
    dmean = abs(float(on_card.mean()) - float(on_cpu.mean()))
    within = float((np.abs(on_card - on_cpu).max(-1) <= NANO_PIX).mean())
    print(f"nanopt: 256x256 16 spp on the card in {nano_s:.2f} s (mean "
          f"{img.mean():.5f}); 64x64 4 spp, the card against the CPU: means "
          f"{on_card.mean():.6f} and {on_cpu.mean():.6f}, {within:.5f} of "
          f"pixels within {NANO_PIX}", flush=True)
    if not (dmean <= NANO_MEAN and within >= NANO_SHARE):
        raise AssertionError(f"nanopt card vs CPU: means {dmean:.3g} apart,"
                             f" {within:.4f} of pixels within {NANO_PIX}")

    # 15e. the parity gate's half that needs no reference binary: the
    # port's two seeds at the reference's size and their noise floor
    walls = []
    paths = []
    for seed in (1234, 977):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths.append(parity_ci.render_kytpu(
            PARITY_SPP, seed, os.path.join(tmp.name, f"parity_{seed}.bmp"),
            PARITY_SIZE, PARITY_SIZE))
        walls.append(time.perf_counter() - t0)
    with ctx.redirect_stdout(sio.StringIO()) as buf:
        floor = float(compare_reference.main(*paths, 8))
    if not 0 < floor < 0.1:
        raise AssertionError(f"parity noise floor {floor}")
    print(f"parity tools: render_kytpu {PARITY_SIZE}^2, {PARITY_SPP} spp, "
          f"the jnp path engine, seeds 1234 and 977 in "
          f"{walls[0]:.2f} and {walls[1]:.2f} s; noise floor "
          f"{buf.getvalue().strip()}; no gate (the reference binary is not "
          f"built here)", flush=True)
    tmp.cleanup()
    return {"launches": {"K1": replay_launches[0], "K2": res_launches[1],
                         "K3": res_launches[2], "K4": replay_launches[3]}}


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch sees none")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch: {name}, {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    from kytpu_torch.cli.inverse import demo_texture
    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff.inverse import make_train_step
    from kytpu_torch.diff.params import TRAINABLE
    from kytpu_torch.integrator.render import render
    from kytpu_torch.kernels import build
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.scene import builders
    STAGE_BUDGET, ACC_BUDGET = kwf.STAGE_BUDGET, kwf.ACC_BUDGET

    ROOM = kwf.DENSE_ROW_COLS, kwf.TAGGED_ROW_COLS

    def on_route(route: str, fn):
        """fn() with K3's and K4's dense rows on accumulator route `route`
        where they fit it (kernels/wavefront.py acc_route: ACC_BUDGET 0
        forces "local", and no room in the local array "device")."""
        kwf.ACC_BUDGET = ACC_BUDGET if route == "shared" else 0
        if route == "device":
            kwf.DENSE_ROW_COLS = kwf.TAGGED_ROW_COLS = 0
        try:
            return fn()
        finally:
            kwf.ACC_BUDGET = ACC_BUDGET
            kwf.DENSE_ROW_COLS, kwf.TAGGED_ROW_COLS = ROOM

    def same_grads(got, ref, what: str) -> None:
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{what}: not the same bits")

    def reset_counts():
        kprof.reset("k1", "k2", "k3", "k4", "tag_sort", "segment_sums")

    # the tag sort's and the segment sums' launches on the main paths
    main_tags = [0, 0]

    def take_tags(what: str, need: bool = True) -> None:
        """Add the tag sort's and segment sums' launches since the last
        reset (`reset_counts`, `reset_big`) to the main paths' counts; a
        path that sums by tag (need) must have launched both."""
        n_sort = kprof.launches("tag_sort")
        n_seg = kprof.launches("segment_sums")
        if need and (n_sort == 0 or n_seg == 0):
            raise AssertionError(f"{what}: the tag sort and segment sums "
                                 f"launched {n_sort} and {n_seg} times")
        main_tags[0] += n_sort
        main_tags[1] += n_seg

    def counts():
        return tuple(map(kprof.launches, ("k1", "k2", "k3", "k4")))

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    each = ", ".join(f"{k} {v:.2f} s" for k, v in build.nvcc_seconds.items())
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds if build.build_seconds else 0:.2f} s; "
          f"each source's nvcc -c, all started together: {each})", flush=True)
    for line in build.ptxas_report.splitlines():
        print(f"build: {line}", flush=True)
    from kytpu_torch.kernels.ab_k1 import ptxas_lines
    for line in ptxas_lines(build.ptxas_report):
        if line.startswith(("wavefront", "bwd_res")):
            print(f"ptxas: {line}", flush=True)

    # 3. kernel vs plain on the card
    n_lanes = 262144
    variant = {builders.LARGE_GLASS_SPHERE, builders.LIGHT_POINT,
               builders.LIGHT_DIRECTION, builders.LIGHT_ENVIRONMENT}
    scenes = {
        "veach": builders.veach_mis(512, 308).to("cuda"),
        "cornell": builders.cornell_box(width=256, height=256).to("cuda"),
        "cornell_lights": builders.cornell_box(variant, width=256,
                                               height=256).to("cuda"),
    }
    # the last field: the tables' route in K1, K2 and K4 (staged in shared
    # memory, or read from device memory: STAGE_BUDGET 0 forces the latter)
    cases = [("veach", "random", "all", "parity", False, "shared"),
             ("veach", "hash", "single", "robust", False, "shared"),
             ("veach", "sobol", "all", "parity", False, "shared"),
             ("veach", "random", "all", "parity", True, "shared"),
             ("veach", "hash", "all", "robust", True, "device"),
             ("cornell", "hash", "all", "robust", False, "shared"),
             ("cornell", "sobol", "single", "robust", False, "shared"),
             ("cornell", "random", "all", "parity", False, "device"),
             ("cornell_lights", "random", "single", "parity", False,
              "shared"),
             ("cornell_lights", "hash", "all", "parity", False, "shared")]
    max_abs_err = 0.0                # K1
    err_res = err_bwd = 0.0          # K2, K3
    err_replay = 0.0                 # K4
    for sc_name, sampler, nee, shadow, texp, route in cases:
        scene = scenes[sc_name]
        cfg = kwf.KernelConfig(max_depth=5, sampler=sampler, nee=nee,
                               shadow=shadow, trainable_exponent=texp)
        tag = f"{sc_name} {sampler}/{nee}/{shadow}" + (
            " trainable exponent" if texp else "") + f", tables in {route} memory"
        o, d, si, pix = jittered_rays(scene, n_lanes, 11)
        kwf.STAGE_BUDGET = STAGE_BUDGET if route == "shared" else 0
        tables = kwf.pack_tables(scene, cfg)
        if (tables.stage_bytes > 0) != (route == "shared"):
            raise AssertionError(f"{tag}: the tables take the other route")
        before = kprof.launches("k1")
        got = kwf.render_lanes_cuda(scene, o, d, 77, cfg, si, pix)
        torch.cuda.synchronize()
        if kprof.launches("k1") != before + 1:
            raise AssertionError("render_lanes_cuda did not launch the kernel")
        ref = kwf.trace_lanes_plain(tables, cfg, o, d, 77, si, pix)
        share, mabs, mdev = compare(got, ref, tag)
        same_bits(got, ref, f"K1 {tag}")
        max_abs_err = max(max_abs_err, mabs)
        print(f"kernel vs plain: {tag}: "
              f"{n_lanes} lanes, {share:.5f} outside rtol={RTOL}/atol={ATOL}, "
              f"max |err| {mabs:.3g}, mean within {mdev:.2f} SE; K1 = plain "
              f"bit for bit", flush=True)
        # K2, K3 and K4 on the same lanes
        before = counts()
        k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 77, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
        grads = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        again = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        k4 = kwf.bwd_replay(tables, cfg, o, d, 77, si, pix, g, got)
        k4_again = kwf.bwd_replay(tables, cfg, o, d, 77, si, pix, g, got)
        torch.cuda.synchronize()
        if counts() != (before[0], before[1] + 1, before[2] + 2,
                        before[3] + 2):
            raise AssertionError("trace_lanes/bwd_res/bwd_replay did not "
                                 "launch K2/K3/K4")
        if not torch.equal(k2, got):
            raise AssertionError("K2's radiance is not K1's bit for bit")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError("K3's gradient does not repeat bit for bit")
        if not all(torch.equal(a, b) for a, b in zip(k4, k4_again)):
            raise AssertionError("K4's gradient does not repeat bit for bit")
        ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 77, si,
                                                    pix, residual=True)
        share2, mabs2, _ = compare(k2, ref_l, f"K2 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K2 cache {tag}")
        same_bits((k2, resf, resi), (ref_l, ref_f, ref_i), f"K2 {tag}")
        ref3 = kwf.bwd_res_plain(tables, cfg, g, ref_l, ref_f, ref_i)
        ref4 = kwf.bwd_replay_plain(tables, cfg, o, d, 77, si, pix, g, ref)
        gerr = compare_grads(grads, ref3, f"K3 {tag}")
        rerr = compare_grads(k4, ref4, f"K4 {tag}")
        xerr = compare_grads(k4, grads, f"K4 vs K3 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        err_res = max(err_res, mabs2, cerr)
        err_bwd = max(err_bwd, gerr)
        err_replay = max(err_replay, rerr)
        # each accumulator route, and K4's chunk at these lanes
        by_route, errs = {}, []
        for route in kwf.ACC_ROUTES:
            if on_route(route, lambda: (kwf.acc_route(tables, cfg),
                                        kwf.acc_route(tables, cfg, True))) \
                    != (route, route):
                raise AssertionError(f"{tag}: not on the {route} route")
            r3, r3b, r4, r4b = on_route(route, lambda: (
                kwf.bwd_res(tables, cfg, g, k2, resf, resi),
                kwf.bwd_res(tables, cfg, g, k2, resf, resi),
                kwf.bwd_replay(tables, cfg, o, d, 77, si, pix, g, got),
                kwf.bwd_replay(tables, cfg, o, d, 77, si, pix, g, got)))
            same_grads(r3b, r3, f"K3 {route} route {tag} again")
            same_grads(r4b, r4, f"K4 {route} route {tag} again")
            errs.append(max(compare_grads(r3, ref3, f"K3 {route} {tag}"),
                            compare_grads(r4, ref4, f"K4 {route} {tag}")))
            by_route[route] = (r3, r4)
        for k in (0, 1):
            same_grads(by_route["shared"][k], by_route["local"][k],
                       f"K{k + 3} shared vs local route {tag}")
            same_grads(by_route["device"][k], by_route["local"][k],
                       f"K{k + 3} device vs local route {tag}")
        same_grads(grads, by_route[kwf.acc_route(tables, cfg)][0],
                   f"K3 {tag}: its route's")
        same_grads(k4, by_route[kwf.acc_route(tables, cfg, True)][1],
                   f"K4 {tag}: its route's")
        chunk4 = kwf.refill_chunk(tables, cfg, n_lanes, replay=True)
        if chunk4 != 32:
            raise AssertionError(f"K4 refills at {n_lanes} lanes: {chunk4}")
        print(f"accumulator routes: {tag}: K3 and K4 on every route "
              f"({kwf._row_cols(tables, cfg)} of {kwf._n_cols(tables, cfg)} "
              f"columns kept; a K3 block {kwf.acc_bytes(tables, cfg)} B and "
              f"a K4 block {kwf.acc_bytes(tables, cfg, True)} B of shared "
              f"memory on the shared one) within the bound of the plain "
              f"versions (max |err| {', '.join(f'{e:.3g}' for e in errs)}), "
              f"each repeats bit for bit, local = shared = device bit for "
              f"bit; K3 on "
              f"{kwf.acc_route(tables, cfg)}, K4 on "
              f"{kwf.acc_route(tables, cfg, True)}; K4 in {chunk4}-lane "
              f"chunks", flush=True)
        print(f"residual kernels vs plain: {tag}: K2 radiance and cache = "
              f"plain bit for bit; "
              f"K2 radiance = K1's bit for bit, {share2:.5f} of lanes outside "
              f"vs plain (max |err| {mabs2:.3g}); cache {resf.shape[0]}+"
              f"{resi.shape[0]} planes within the bound (max |err| "
              f"{cerr:.3g}); K3 within the bound (max |err| {gerr:.3g}), "
              f"repeats bit for bit", flush=True)
        print(f"replay kernel vs plain: {tag}: K4 within the bound (max "
              f"|err| {rerr:.3g}), repeats bit for bit; K4 vs K3 within "
              f"rtol={CROSS_RTOL}/atol={CROSS_ATOL} (max |diff| {xerr:.3g})",
              flush=True)
        if texp:
            ix, _ = kwf.residual_layout(tables.static, cfg)
            kplanes = [k for t, k in ix.items() if t[0] in ("Bk", "tuk")]
            kerr = float((resf[kplanes] - ref_f[kplanes]).abs().max())
            live = int((ref_f[kplanes] != 0).sum())
            print(f"exponent: {tag}: {len(kplanes)} Bk/tuk planes "
                  f"({live} nonzero entries) within the bound (max |err| "
                  f"{kerr:.3g}); dexp of K3 {grads[4].tolist()}, of K4 "
                  f"{k4[4].tolist()}", flush=True)
            if live == 0 or not bool((grads[4] != 0).any()):
                raise AssertionError("the exponent case exercised no "
                                     "phong lane")

    kwf.STAGE_BUDGET = STAGE_BUDGET

    # 3b. past ACC_BUDGET: 32 lights, 300 columns a row
    sc32 = many_lights(builders, 32, 512, 512).to("cuda")
    for sampler, nee in (("hash", "all"), ("sobol", "single")):
        cfg = kwf.KernelConfig(max_depth=5, sampler=sampler, nee=nee)
        tag = f"32 lights {sampler}/{nee}"
        o, d, si, pix = jittered_rays(sc32, n_lanes, 13)
        tables = kwf.pack_tables(sc32, cfg)
        if on_route("shared", lambda: (kwf.acc_route(tables, cfg),
                                       kwf.acc_route(tables, cfg, True))) \
                != ("local", "local"):
            raise AssertionError(f"{tag}: the shared route fits")
        k1 = kwf.trace_lanes(tables, cfg, o, d, 31, si, pix)
        k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 31, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(6))
        grads = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        k4 = kwf.bwd_replay(tables, cfg, o, d, 31, si, pix, g, k1)
        ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 31, si,
                                                    pix, residual=True)
        same_bits((k2, resf, resi), (ref_l, ref_f, ref_i), f"K2 {tag}")
        ref3 = kwf.bwd_res_plain(tables, cfg, g, ref_l, ref_f, ref_i)
        ref4 = kwf.bwd_replay_plain(tables, cfg, o, d, 31, si, pix, g, ref_l)
        same_grads(kwf.bwd_res(tables, cfg, g, k2, resf, resi), grads,
                   f"K3 {tag} again")
        same_grads(kwf.bwd_replay(tables, cfg, o, d, 31, si, pix, g, k1), k4,
                   f"K4 {tag} again")
        errs = [(compare_grads(grads, ref3, f"K3 {tag}"),
                 compare_grads(k4, ref4, f"K4 {tag}"))]
        xerr = compare_grads(k4, grads, f"K4 vs K3 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        err_bwd = max(err_bwd, *(e3 for e3, _ in errs))
        err_replay = max(err_replay, *(e4 for _, e4 in errs))
        print(f"accumulator routes: {tag}, {n_lanes} lanes, depth 5 "
              f"({kwf._row_cols(tables, cfg)} of {kwf._n_cols(tables, cfg)} "
              f"columns kept, a K4 block "
              f"{kwf.acc_bytes(tables, cfg, replay=True)} B on the shared "
              f"route): K3 and K4 on the {kwf.acc_route(tables, cfg)} and "
              f"{kwf.acc_route(tables, cfg, True)} routes within the bound "
              f"(max |err| {errs[0][0]:.3g} and {errs[0][1]:.3g}), each "
              f"repeats bit for bit; K4 vs K3 max |diff| {xerr:.3g}",
              flush=True)
    del sc32, k1, k2, resf, resi, g, grads, k4, ref_l, ref_f, ref_i

    # 3c. the camera jitter and rays kernel against its plain chain
    from kytpu_torch.kernels import camera as kcam
    rays_cam = builders.veach_mis(512, 308).to("cuda").camera
    rays_npix = 512 * 308
    rays_words = krng.words(krng.fold_in(krng.key(2**31 + 3), 7))
    rays_n = {"train": rays_npix * 64, "pass": rays_npix * 6}
    for mode, base in (("random", 0), ("hash", 6)):
        for n in (rays_n["train"], rays_n["pass"], rays_n["pass"] + 77):
            before = kprof.launches("rays")
            _, d = kcam.lane_rays(rays_cam, rays_words, n, rays_npix, mode,
                                  base)
            torch.cuda.synchronize()
            if kprof.launches("rays") != before + 1:
                raise AssertionError(f"rays {mode} {n}: not one launch")
            _, ref = kcam.lane_rays_plain(rays_cam, rays_words, n, rays_npix,
                                          mode, base)
            same_bits(d.view(torch.int32), ref.view(torch.int32),
                      f"rays {mode} {n} lanes")
    del d, ref
    rays_ms, rays_plain_ms = {}, {}
    for what, n in rays_n.items():
        rays_ms[what], _ = cuda_time_ms(lambda: kcam.lane_rays(
            rays_cam, rays_words, n, rays_npix, "random"), 20)
        rays_plain_ms[what], _ = cuda_time_ms(lambda: kcam.lane_rays_plain(
            rays_cam, rays_words, n, rays_npix, "random"), 3)
    # two Threefry blocks a lane of about 80 int32 operations each; a lane
    # reads nothing and writes 12 bytes
    rays_bound = bound_ms(12 * rays_n["train"], 0.0)
    rays_ops_ms = 2 * 80 * rays_n["train"] / INT32_OPS_S * 1e3
    if rays_ops_ms >= rays_bound[0]:
        rays_bound = (rays_ops_ms, "int32 operations")
    print(f"rays: the camera-rays kernel = its plain chain bit for bit "
          f"(random; hash at sample base 6) at {rays_n['train']}, "
          f"{rays_n['pass']} and {rays_n['pass'] + 77} lanes, one launch "
          f"each; random: {rays_ms['train']:.4f} ms at the train step's "
          f"lanes (plain {rays_plain_ms['train']:.3f}), "
          f"{rays_ms['pass']:.4f} ms at a frame pass's (plain "
          f"{rays_plain_ms['pass']:.3f}); bound {rays_bound[0]:.4f} ms by "
          f"{rays_bound[1]} at the train step's", flush=True)

    # 4. frames through the main path (render, engine="cuda")
    veach_frame = builders.veach_mis(512, 308)
    frame_scenes = {"veach": veach_frame,
                    "cornell": builders.cornell_box(width=256, height=256)}
    # (scene, render's cfg) of each frame; None is render()'s default
    frame_cases = {**{nm: (sc, None) for nm, sc in frame_scenes.items()},
                   "veach sobol": (veach_frame,
                                   kwf.KernelConfig(sampler="sobol"))}
    spp, seed = 64, 1234

    def frame(sc, n_spp, cfg=None):
        return render(sc, spp=n_spp, seed=seed, cfg=cfg, clamp=False,
                      engine="cuda", device="cuda")

    reset_counts()
    kprof.reset("rays")
    frames = {}
    for nm, (sc, fcfg) in frame_cases.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = frame(sc, spp, fcfg)
        torch.cuda.synchronize()
        frames[nm] = (img, time.perf_counter() - t0)
    render_launches = counts()
    if render_launches[0] == 0:
        raise AssertionError("the main path launched no kernel")
    # one rays launch a pass: Veach 11 passes, Cornell 4, none under sobol
    main_rays = kprof.launches("rays")
    if main_rays != 11 + 4:
        raise AssertionError(f"the frames launched the rays kernel "
                             f"{main_rays} times, not 15")
    for nm, (img, secs) in frames.items():
        a = img.cpu().numpy()
        if a.shape[-1] != 3 or not np.isfinite(a).all() or (a < 0).any():
            raise AssertionError(f"{nm} frame: not finite and non-negative")
        print(f"frame: {nm} {a.shape[1]}x{a.shape[0]} {spp} spp in {secs:.3f} s, "
              f"mean {a.mean():.5f}, clamped mean {np.clip(a, 0, 1).mean():.5f}",
              flush=True)
    for nm, (sc, fcfg) in frame_cases.items():
        # the same render, traced by the plain version instead
        sc = sc.to("cuda")
        cfg = fcfg or kwf.KernelConfig()
        tables = kwf.pack_tables(sc, cfg)

        def plain(s, o, d, *args):
            return kwf.trace_lanes_plain(tables, cfg, o, d, *args)

        for n_spp in ((spp, 4) if fcfg is None else (spp,)):
            got = frames[nm][0] if n_spp == spp else frame(sc, n_spp)
            ref = kwf.render_cuda(sc, spp=n_spp, seed=seed, cfg=cfg,
                                  clamp=False, rays_per_pass=1 << 20,
                                  tracer=plain)
            share, mabs, _ = compare(got.reshape(-1, 3), ref.reshape(-1, 3),
                                     f"{nm} {n_spp}-spp frame")
            max_abs_err = max(max_abs_err, mabs)
            print(f"frame vs plain: {nm} {n_spp} spp: {share:.5f} of pixels "
                  f"outside the bound, max |err| {mabs:.3g}", flush=True)
    for nm, sc in frame_scenes.items():
        frame(sc, spp)   # warm
        walls = []
        for _ in range(5):   # host time varies from frame to frame
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(sc, spp)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls))
        busy, mine, n_k = device_profile(lambda: frame(sc, spp),
                                         {"K1": K1_NAMES})
        mine = mine["K1"]
        print(f"profile: {nm} {spp} spp: wall {wall:.3f} ms (median of 5 "
              f"warmed frames, not profiled: {min(walls):.3f}-"
              f"{max(walls):.3f}); device busy {busy:.3f} ms in {n_k} kernels "
              f"(idle share {1 - busy / wall:.3f}); wavefront_fwd {mine:.3f} "
              f"ms = {mine / busy:.3f} of device busy time, "
              f"{mine / wall:.3f} of wall", flush=True)

    # 5. timing: Veach forward, depth 5
    n_time = 1 << 22
    sc = scenes["veach"]
    cfg = kwf.KernelConfig(max_depth=5)
    o, d, _, _ = jittered_rays(sc, n_time, 3)
    tracer = kwf.make_cuda_tracer(sc, cfg)
    tables = kwf.pack_tables(sc, cfg)
    ms, got = cuda_time_ms(lambda: tracer(sc, o, d, 5), 5)
    plain_ms, ref = cuda_time_ms(
        lambda: kwf.trace_lanes_plain(tables, cfg, o, d, 5), 1)
    share, mabs, mdev = compare(got, ref, f"veach {n_time} lanes")
    same_bits(got, ref, f"K1 veach {n_time} lanes")
    max_abs_err = max(max_abs_err, mabs)
    print(f"timing: veach fwd depth 5, {n_time} lanes: kernel {ms:.3f} ms "
          f"({n_time / ms / 1e3:.1f} Mrays/s), plain {plain_ms:.1f} ms "
          f"({n_time / plain_ms / 1e3:.2f} Mrays/s) on {smi}; "
          f"{share:.5f} of lanes outside the bound, max |err| {mabs:.3g}, "
          f"K1 = plain bit for bit", flush=True)

    del ref

    # 6. forward+backward: bench.py's workload through the diff tracer
    leaves = [t.clone().requires_grad_() for t in
              (sc.mat_diffuse, sc.mat_specular, sc.emission)]
    env0 = torch.zeros(3, device="cuda")
    diff_tracer = kwf.make_cuda_diff_tracer(sc, cfg)

    def fwd_bwd():
        for t in leaves:
            t.grad = None
        loss = diff_tracer(*leaves, env0, o, d, 5).sum() / n_time
        loss.backward()
        return loss

    fb_ms, _ = cuda_time_ms(fwd_bwd, 5)
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res_grads = [t.grad.clone() for t in leaves]

    # the same workload through the replay path (K1 forward, K4 backward)
    replay_tracer = kwf.make_cuda_diff_tracer(sc, cfg, backward="replay")

    def fwd_bwd_replay():
        for t in leaves:
            t.grad = None
        loss = replay_tracer(*leaves, env0, o, d, 5).sum() / n_time
        loss.backward()
        return loss

    torch.cuda.synchronize()
    reset_counts()
    fbr_ms, _ = cuda_time_ms(fwd_bwd_replay, 5)
    replay_launches = counts()
    if replay_launches[3] == 0 or replay_launches[1:3] != (0, 0):
        raise AssertionError(f"the replay path launched K1/K2/K3/K4 "
                             f"{replay_launches}")
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd_replay()
    torch.cuda.synchronize()
    peak_replay_gb = torch.cuda.max_memory_allocated() / 1e9
    k2_ms, (k2, resf, resi) = cuda_time_ms(
        lambda: kwf.trace_lanes(tables, cfg, o, d, 5, residual=True), 5)
    k1_ms, k1 = cuda_time_ms(lambda: kwf.trace_lanes(tables, cfg, o, d, 5), 5)
    g = torch.full((n_time, 3), 1.0 / n_time, device="cuda")
    k3_ms, grads = cuda_time_ms(
        lambda: kwf.bwd_res(tables, cfg, g, k2, resf, resi), 5)
    if not (torch.equal(k1, k2) and torch.equal(k1, got)):
        raise AssertionError("K2's radiance is not K1's bit for bit at 4M lanes")
    if not all(torch.equal(a, b) for a, b in zip(grads, res_grads)):
        raise AssertionError("the diff tracer's gradient is not K3's")
    k4_ms, k4 = cuda_time_ms(
        lambda: kwf.bwd_replay(tables, cfg, o, d, 5, None, None, g, k1), 5)
    if not all(torch.equal(a, t.grad) for a, t in zip(k4, leaves)):
        raise AssertionError("the replay tracer's gradient is not K4's")
    chunk4 = kwf.refill_chunk(tables, cfg, n_time, replay=True)
    if chunk4 <= 32:
        raise AssertionError(f"K4 does not refill at {n_time} lanes")
    # each accumulator route on the same lanes
    route_ms, by_route = {}, {}
    for route in kwf.ACC_ROUTES:
        t3, r3 = on_route(route, lambda: cuda_time_ms(
            lambda: kwf.bwd_res(tables, cfg, g, k2, resf, resi), 5))
        t4, r4 = on_route(route, lambda: cuda_time_ms(
            lambda: kwf.bwd_replay(tables, cfg, o, d, 5, None, None, g, k1),
            5))
        route_ms[route], by_route[route] = (t3, t4), (r3, r4)
    for k in (0, 1):
        for route, got_r in by_route.items():
            same_grads(got_r[k], (grads, k4)[k],
                       f"K{k + 3} {route} route veach {n_time} lanes")
    del by_route
    print(f"accumulator routes: veach depth 5, {n_time} lanes "
          f"({kwf._row_cols(tables, cfg)} of {kwf._n_cols(tables, cfg)} "
          f"columns kept): "
          + "; ".join(f"{r}: K3 {t3:.3f} ms, K4 {t4:.3f} ms"
                      for r, (t3, t4) in route_ms.items())
          + f" (a shared K3 block {kwf.acc_bytes(tables, cfg)} B, a K4 block "
          f"{kwf.acc_bytes(tables, cfg, True)} B); K3 on "
          f"{kwf.acc_route(tables, cfg)}, K4 on "
          f"{kwf.acc_route(tables, cfg, True)} ({chunk4}-lane chunks); the "
          f"same bits on every route; on {smi}", flush=True)
    # the row-tagged K3 and K4 (the route past 64 surfaces) forced on the
    # same lanes: what the dense route saves at Veach's rows
    kwf.DENSE_MAX_ROWS = 0
    try:
        k3t_ms, k3t = cuda_time_ms(
            lambda: kwf.bwd_res(tables, cfg, g, k2, resf, resi), 5)
        k4t_ms, k4t = cuda_time_ms(
            lambda: kwf.bwd_replay(tables, cfg, o, d, 5, None, None, g, k1), 5)
    finally:
        kwf.DENSE_MAX_ROWS = 64
    terr = max(compare_grads(k3t, grads, f"tagged K3 vs K3 veach {n_time} "
                             "lanes"),
               compare_grads(k4t, k4, f"tagged K4 vs K4 veach {n_time} lanes"))
    del k3t, k4t
    print(f"row-tagged route forced: veach depth 5, {n_time} lanes: K3 "
          f"{k3t_ms:.3f} ms against the dense K3's {k3_ms:.3f} ms, K4 "
          f"{k4t_ms:.3f} ms against the dense K4's {k4_ms:.3f} ms (with the "
          f"sorts and sums by row); tagged vs dense max |diff| {terr:.3g}; on "
          f"{smi}", flush=True)
    plain_k2_ms, (ref_l, ref_f, ref_i) = cuda_time_ms(
        lambda: kwf.trace_lanes_plain(tables, cfg, o, d, 5, residual=True), 1)
    plain_k3_ms, ref_g = cuda_time_ms(
        lambda: kwf.bwd_res_plain(tables, cfg, g, ref_l, ref_f, ref_i), 1)
    plain_k4_ms, ref_g4 = cuda_time_ms(
        lambda: kwf.bwd_replay_plain(tables, cfg, o, d, 5, None, None, g,
                                     ref_l), 1)
    share, mabs, _ = compare(k2, ref_l, f"K2 veach {n_time} lanes")
    cerr = compare_cache(resf, resi, ref_f, ref_i, f"K2 cache {n_time} lanes")
    same_bits((k2, resf, resi), (ref_l, ref_f, ref_i),
              f"K2 veach {n_time} lanes")
    gerr = compare_grads(grads, ref_g, f"K3 veach {n_time} lanes")
    rerr = compare_grads(k4, ref_g4, f"K4 veach {n_time} lanes")
    xerr = compare_grads(k4, grads, f"K4 vs K3 veach {n_time} lanes",
                         CROSS_RTOL, CROSS_ATOL)
    err_res = max(err_res, mabs, cerr)
    err_bwd = max(err_bwd, gerr)
    err_replay = max(err_replay, rerr)
    del ref_l, ref_f, ref_i, ref_g, ref_g4
    cache_bytes = resf.numel() * 4 + resi.numel() * 4
    ray_bytes = n_time * (24 + 12)   # rays in, radiance out
    ops1 = k1_ops(tables.static, resf, cfg)
    ops4 = k4_ops(tables.static, resf, cfg)
    bounds = {
        "K1": bound_ms(ray_bytes, ops1),
        "K2": bound_ms(ray_bytes + cache_bytes, ops1),
        "K3": bound_ms(cache_bytes + n_time * 24,
                       k3_ops(tables.static, cfg, n_time)),
        # rays, g and L in; the gradient vector out is a few hundred bytes
        "K4": bound_ms(n_time * (24 + 12 + 12), ops4),
    }
    print(f"fwd+bwd: veach depth 5, {n_time} lanes, loss = out.sum() / N "
          f"through make_cuda_diff_tracer: {fb_ms:.3f} ms, peak memory "
          f"{peak_gb:.3f} GB allocated (rays included); K2 {k2_ms:.3f} ms, "
          f"K3 {k3_ms:.3f} ms, K1 {k1_ms:.3f} ms; plain K2 {plain_k2_ms:.1f} "
          f"ms, plain K3 {plain_k3_ms:.1f} ms; cache {resf.shape[0]} float + "
          f"{resi.shape[0]} int planes = {cache_bytes / 1e9:.4f} GB "
          f"({cache_bytes / n_time:.0f} B a lane); K2 vs plain {share:.5f} of "
          f"lanes outside (max |err| {mabs:.3g}), cache max |err| {cerr:.3g}, "
          f"K3 max |err| {gerr:.3g}; on {smi}", flush=True)
    print(f"replay: veach depth 5, {n_time} lanes, loss = out.sum() / N "
          f"through make_cuda_diff_tracer(backward=\"replay\"): {fbr_ms:.3f} "
          f"ms, peak memory {peak_replay_gb:.3f} GB allocated (rays "
          f"included; the residual path's {peak_gb:.3f} GB); launches "
          f"K1/K2/K3/K4 {replay_launches}; K4 {k4_ms:.3f} ms, plain K4 "
          f"{plain_k4_ms:.1f} ms; the tracer's gradient = K4's bit for bit; "
          f"K4 vs plain max |err| {rerr:.3g}; K4 vs K3 within "
          f"rtol={CROSS_RTOL}/atol={CROSS_ATOL} (max |diff| {xerr:.3g}); on "
          f"{smi}", flush=True)
    for k, (b_ms, by) in bounds.items():
        print(f"bound: {k} {b_ms:.4f} ms by {by} (K1 ops {ops1:.4g}, K4 ops "
              f"{ops4:.4g}, cache {cache_bytes:.4g} B)", flush=True)
    # the tables read from device memory instead of staged in shared memory
    # (the route of tables past STAGE_BUDGET), on the same lanes
    kwf.STAGE_BUDGET = 0
    try:
        dk1_ms, dk1 = cuda_time_ms(
            lambda: kwf.trace_lanes(tables, cfg, o, d, 5), 5)
        dk2_ms, dk2 = cuda_time_ms(
            lambda: kwf.trace_lanes(tables, cfg, o, d, 5, residual=True), 5)
    finally:
        kwf.STAGE_BUDGET = STAGE_BUDGET
    same_bits(dk1, k1, "K1, tables in device memory")
    same_bits(dk2, (k2, resf, resi), "K2, tables in device memory")
    del dk1, dk2
    print(f"tables in device memory: veach depth 5, {n_time} lanes: K1 "
          f"{dk1_ms:.3f} ms, K2 {dk2_ms:.3f} ms, against {k1_ms:.3f} and "
          f"{k2_ms:.3f} ms with the tables ({tables.stage_bytes} B) staged in "
          f"shared memory; the same bits; on {smi}", flush=True)
    chunk = kwf.refill_chunk(tables, cfg, n_time, residual=True)
    lane_bounces, simt_before, simt_after = simt_share(tables.static, resf,
                                                       cfg, chunk)
    print(f"SIMT: veach depth 5, {n_time} lanes, from K2's cache: "
          f"{lane_bounces} lane-bounces over 32 x the warps' iterations: "
          f"{simt_before:.4f} one lane a thread (a warp runs its longest "
          f"path), {simt_after:.4f} with dead-lane refill ({chunk} lanes a "
          f"warp)", flush=True)
    del k1, k2, resf, resi, grads, g, got, k4

    # 7. training through make_train_step (the second main path)
    true_sc = builders.cornell_box(width=256, height=256)
    tcfg = kwf.KernelConfig(max_depth=3, sampler="hash")
    target = render(true_sc, spp=64, seed=99, cfg=tcfg, clamp=False)
    start = dataclasses.replace(true_sc,
                                mat_diffuse=true_sc.mat_diffuse * 0.4)
    step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                      kernel_sampler="hash")
    key = krng.fold_in(krng.key(0), 1)
    err0 = float((params["mat_diffuse"].detach().cpu()
                  - true_sc.mat_diffuse).abs().mean())
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    kprof.reset("rays")
    for i in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(key)))
        walls.append((time.perf_counter() - t0) * 1e3)
    train_launches = counts()
    if train_launches[1] == 0 or train_launches[2] == 0:
        raise AssertionError("the train step launched no K2 or K3")
    if kprof.launches("rays") != 5:
        raise AssertionError(f"five train steps launched the rays kernel "
                             f"{kprof.launches('rays')} times")
    main_rays += 5
    err5 = float((params["mat_diffuse"].detach().cpu()
                  - true_sc.mat_diffuse).abs().mean())
    if not (np.isfinite(losses).all() and np.all(np.diff(losses) < 0)
            and err5 < err0):
        raise AssertionError(f"the loss did not fall: {losses}, mean "
                             f"|diffuse - true| {err0} -> {err5}")
    if not all(bool((p >= 0).all()) for p in params.values()):
        raise AssertionError("a parameter went negative")
    step_ms = float(np.median(walls[1:]))
    print(f"train: cornell 256x256, 4 spp, depth 3, hash: losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; mean |diffuse - true| "
          f"{err0:.5f} -> {err5:.5f}; {step_ms:.3f} ms a step (median of "
          f"steps 2-5; all: {', '.join(f'{v:.1f}' for v in walls)}); "
          f"launches K1/K2/K3/K4 {train_launches}", flush=True)
    busy, mine, n_k = device_profile(
        lambda: step(key),
        {"K2": K2_NAMES, "K3": K3_NAMES})
    print(f"profile: train step: device busy {busy:.3f} ms in {n_k} kernels "
          f"(idle share {1 - busy / step_ms:.3f} of the median step); K2 "
          f"{mine['K2']:.3f} ms, K3 {mine['K3']:.3f} ms = "
          f"{(mine['K2'] + mine['K3']) / busy:.3f} of device busy time",
          flush=True)
    # the train step's own K2 and K3 calls against their plain versions
    with recording(kwf) as seen:
        step(key)
        torch.cuda.synchronize()
    e2, e3 = check_recorded_step(kwf, seen, "train step")
    err_res, err_bwd = max(err_res, e2), max(err_bwd, e3)

    # 8. glossiness: the train step with the exponent trainable, on Veach
    true_v = builders.veach_mis(512, 308)
    names = TRAINABLE + ("mat_exponent",)
    vcfg = kwf.KernelConfig(max_depth=3, sampler="sobol")
    target = render(true_v, spp=64, seed=99, cfg=vcfg, clamp=False)
    planks = true_v.mat_kind == 3   # the four Phong planks
    e_true = true_v.mat_exponent[planks].double()
    start = dataclasses.replace(true_v,
                                mat_exponent=true_v.mat_exponent * 0.5)
    step, params, _ = make_train_step(
        start, target, spp=4, max_depth=3, kernel_sampler="sobol",
        names=names, param_spaces={"mat_exponent": "log"})

    def exp_err():
        e = params["mat_exponent"].detach().cpu()[planks].double()
        return float((e.log() - e_true.log()).abs().mean())

    err0 = exp_err()
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    for i in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(key)))
        walls.append((time.perf_counter() - t0) * 1e3)
    gloss_launches = counts()
    if gloss_launches[1] == 0 or gloss_launches[2] == 0:
        raise AssertionError("the glossiness step launched no K2 or K3")
    err5 = exp_err()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and err5 < err0):
        raise AssertionError(f"the loss did not fall: {losses}, mean |log e "
                             f"- log e_true| {err0} -> {err5}")
    if not all(bool((p >= 0).all()) for p in params.values()):
        raise AssertionError("a parameter went negative")
    gstep_ms = float(np.median(walls[1:]))
    print(f"glossiness: veach 512x308, 4 spp, depth 3, sobol, "
          f"TRAINABLE + mat_exponent (softplus space), plank exponents "
          f"halved: losses {', '.join(f'{v:.6f}' for v in losses)}; mean "
          f"|log e - log e_true| over the planks {err0:.6f} -> {err5:.6f}; "
          f"{gstep_ms:.3f} ms a step (median of steps 2-5; all: "
          f"{', '.join(f'{v:.1f}' for v in walls)}); launches K1/K2/K3/K4 "
          f"{gloss_launches}", flush=True)
    busy, mine, n_k = device_profile(
        lambda: step(key), {"K2": K2_NAMES, "K3": K3_NAMES})
    print(f"profile: glossiness step: device busy {busy:.3f} ms in {n_k} "
          f"kernels (idle share {1 - busy / gstep_ms:.3f} of the median "
          f"step); K2 {mine['K2']:.3f} ms, K3 {mine['K3']:.3f} ms = "
          f"{(mine['K2'] + mine['K3']) / busy:.3f} of device busy time",
          flush=True)
    with recording(kwf) as seen:
        step(key)
        torch.cuda.synchronize()
    e2, e3 = check_recorded_step(kwf, seen, "glossiness step")
    err_res, err_bwd = max(err_res, e2), max(err_bwd, e3)

    # 9. big scenes: the table-driven kernels K5, K6 and K7
    from kytpu_torch.kernels import bigscene as kbs
    from kytpu_torch.scene import mesh

    def reset_big():
        kprof.reset("k5", "k6", "k7", "k8", "tag_sort", "segment_sums")

    def big_counts():
        return tuple(map(kprof.launches, ("k5", "k6", "k7", "k8")))

    big = {"spheres": builders.random_spheres(n=1024, width=256, height=256),
           "mesh": builders.mesh_scene(*mesh.icosphere(subdivisions=3),
                                       width=256, height=256)}
    big_cuda = {nm: sc.to("cuda") for nm, sc in big.items()}
    for nm, sc in big.items():
        print(f"big scene: {nm}: {int(sc.mat_kind.shape[0])} surfaces, "
              f"{len(sc.lights.kinds)} lights, class rows (tri, rect, disk, "
              f"sphere) {kbs.pack_big_tables(sc, kwf.KernelConfig()).counts}",
              flush=True)
    # 9a. each kernel against its plain version, 64K lanes, every sampler
    err_k5 = err_k6 = err_k7 = err_k8 = 0.0
    big_cases = [("spheres", "random", "parity", False),
                 ("spheres", "hash", "robust", True),
                 ("spheres", "sobol", "parity", False),
                 ("mesh", "random", "robust", False),
                 ("mesh", "hash", "parity", False),
                 ("mesh", "sobol", "robust", True)]
    for sc_name, sampler, shadow, texp in big_cases:
        scene = big_cuda[sc_name]
        cfg = kwf.KernelConfig(max_depth=3, sampler=sampler, shadow=shadow,
                               trainable_exponent=texp)
        tag = f"{sc_name} {sampler}/{shadow}" + (
            " trainable exponent" if texp else "")
        o, d, si, pix = jittered_rays(scene, 1 << 16, 13)
        tables = kbs.pack_big_tables(scene, cfg)
        before = big_counts()
        k5 = kbs.trace_lanes(tables, cfg, o, d, 21, si, pix)
        k6, resf, resi = kbs.trace_lanes(tables, cfg, o, d, 21, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
        grads = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
        again = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
        k8 = kbs.bwd_replay(tables, cfg, o, d, 21, si, pix, g, k5)
        k8_again = kbs.bwd_replay(tables, cfg, o, d, 21, si, pix, g, k5)
        torch.cuda.synchronize()
        if big_counts() != (before[0] + 1, before[1] + 1, before[2] + 2,
                            before[3] + 2):
            raise AssertionError("trace_lanes/bwd_res/bwd_replay did not "
                                 "launch K5/K6/K7/K8")
        if not all(torch.equal(a, b) for a, b in zip(k8, k8_again)):
            raise AssertionError(f"K8's gradient does not repeat bit for bit, "
                                 f"{tag}")
        if not torch.equal(k5, k6):
            raise AssertionError(f"K6's radiance is not K5's bit for bit, {tag}")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"K7's gradient does not repeat bit for bit, "
                                 f"{tag}")
        same_as_cull_off(tables, cfg, (o, d, 21, si, pix), g,
                         (k5, (k6, resf, resi), k8), tag)
        ref_l, ref_f, ref_i = kbs.trace_lanes_plain(
            tables, cfg, o, d, 21, si, pix, residual=True)
        share, mabs, mdev = compare(k5, ref_l, f"K5 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K6 cache {tag}")
        gerr = compare_grads(grads, kbs.bwd_res_plain(
            tables, cfg, g, ref_l, ref_f, ref_i), f"K7 {tag}")
        rerr = compare_grads(k8, kbs.sums_plain(tables, cfg, *kbs.bwd_replay_plain(
            tables, cfg, o, d, 21, si, pix, g, k5)), f"K8 {tag}")
        xerr = compare_grads(k8, grads, f"K8 vs K7 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        err_k5, err_k6 = max(err_k5, mabs), max(err_k6, mabs, cerr)
        err_k7, err_k8 = max(err_k7, gerr), max(err_k8, rerr)
        extra = ""
        if texp:
            ix, _ = kbs.layout_of(tables.static, cfg)
            kplanes = [k for t, k in ix.items() if t[0] in ("Bk", "tuk")]
            live = int((ref_f[kplanes] != 0).sum())
            if live == 0 or not bool((grads[4] != 0).any()):
                raise AssertionError(f"{tag}: no phong lane")
            extra = (f"; {len(kplanes)} Bk/tuk planes ({live} nonzero "
                     f"entries), dexp on {int((grads[4] != 0).sum())} rows")
        print(f"big kernels vs plain: {tag}: {o.shape[0]} lanes, depth 3: K5 "
              f"{share:.5f} of lanes outside rtol={RTOL}/atol={ATOL} (max "
              f"|err| {mabs:.3g}, mean within {mdev:.2f} SE); K6 radiance = "
              f"K5's bit for bit, cache {resf.shape[0]}+{resi.shape[0]} planes "
              f"within the bound (max |err| {cerr:.3g}); K5, K6 and K8 with "
              f"cull={cfg.cull!r} = cull='off' bit for bit; K7 within the bound "
              f"(max |err| {gerr:.3g}), repeats bit for bit; K8 within the "
              f"bound (max |err| {rerr:.3g}), repeats bit for bit, vs K7 "
              f"within rtol={CROSS_RTOL}/atol={CROSS_ATOL} (max |diff| "
              f"{xerr:.3g}){extra}", flush=True)
    del k5, k6, resf, resi, ref_l, ref_f, ref_i, grads, again, k8, k8_again

    # 9b. K5 against K1 where both run: the Cornell box, engine="bigscene"
    cornell = scenes["cornell"]
    cfg = kwf.KernelConfig(max_depth=5)
    o, d, _, _ = jittered_rays(cornell, n_lanes, 17)
    k1 = kwf.trace_lanes(kwf.pack_tables(cornell, cfg), cfg, o, d, 31)
    k5 = kbs.trace_lanes(kbs.pack_big_tables(cornell, cfg), cfg, o, d, 31)
    within = float(((k5 - k1).abs() <= 1e-3).all(-1).float().mean())
    reset_big()
    img_b = render(cornell, spp=16, seed=seed, clamp=False, engine="bigscene")
    img_1 = render(cornell, spp=16, seed=seed, clamp=False, engine="cuda")
    torch.cuda.synchronize()
    if big_counts()[0] == 0 or not bool(torch.isfinite(img_b).all()):
        raise AssertionError("render(engine='bigscene') did not run K5")
    if within < 1 - MAX_BAD_SHARE:
        raise AssertionError(f"K5 vs K1 on the Cornell box: only {within:.5f} "
                             "of lanes within 1e-3")
    print(f"K5 vs K1: cornell 256x256, depth 5, {n_lanes} lanes: {within:.5f} "
          f"of lanes within 1e-3 (max |diff| {float((k5 - k1).abs().max()):.3g};"
          f" K5 takes each hit's exponent from its row, K1 folds the one "
          f"static exponent); 16-spp frames through render(engine="
          f"'bigscene') and render(engine='cuda'): mean |diff| "
          f"{float((img_b - img_1).abs().mean()):.3g}", flush=True)
    del k1, k5, img_b, img_1

    # 9c. frames of the big scenes through the main path (render, past 64
    # surfaces: K5)
    bcfg = kwf.KernelConfig(max_depth=3)
    big_spp = 16

    def big_frame(sc):
        return render(sc, spp=big_spp, seed=seed, cfg=bcfg, clamp=False)

    reset_counts()
    reset_big()
    big_frames = {}
    for nm, sc in big.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = big_frame(sc)
        torch.cuda.synchronize()
        big_frames[nm] = (img, time.perf_counter() - t0)
    big_render_launches = big_counts()
    if big_render_launches[0] == 0 or big_render_launches[1:] != (0, 0, 0) \
            or counts() != (0, 0, 0, 0):
        raise AssertionError(f"the big-scene frames launched K5 "
                             f"{big_render_launches[0]} times and K1-K4 "
                             f"{counts()}")
    for nm, (img, secs) in big_frames.items():
        a = img.cpu().numpy()
        if a.shape != (256, 256, 3) or not np.isfinite(a).all() or \
                (a < 0).any() or a.mean() <= 0:
            raise AssertionError(f"{nm} frame: not finite, positive")
        tables = kbs.pack_big_tables(big_cuda[nm], bcfg)
        plain_k5 = (lambda s, o, d, *args, tables=tables:
                    kbs.trace_lanes_plain(tables, bcfg, o, d, *args))
        ref = kwf.render_cuda(big_cuda[nm], spp=big_spp, seed=seed, cfg=bcfg,
                              clamp=False, rays_per_pass=1 << 20,
                              tracer=plain_k5)
        share, mabs, _ = compare(img.reshape(-1, 3), ref.reshape(-1, 3),
                                 f"{nm} frame")
        err_k5 = max(err_k5, mabs)
        print(f"frame: {nm} 256x256 {big_spp} spp, depth 3 in {secs:.3f} s "
              f"(cold), mean {a.mean():.5f}; against the same frame through "
              f"the plain K5: {share:.5f} of pixels outside the bound, max "
              f"|err| {mabs:.3g}", flush=True)
    del ref
    for nm, sc in big.items():
        big_frame(sc)   # warm
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            big_frame(sc)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls))
        busy, mine, n_k = device_profile(lambda: big_frame(sc),
                                         {"K5": K5_NAMES})
        print(f"profile: {nm} frame, {big_spp} spp: wall {wall:.3f} ms "
              f"(median of 5 warmed frames: {min(walls):.3f}-"
              f"{max(walls):.3f}); device busy {busy:.3f} ms in {n_k} kernels "
              f"(idle share {1 - busy / wall:.3f}); bigscene_fwd "
              f"{mine['K5']:.3f} ms = {mine['K5'] / busy:.3f} of device busy "
              f"time, {mine['K5'] / wall:.3f} of wall", flush=True)

    # 9d. benchmarks/run.py's K5 workload: 1M pixel-centre lanes, depth 3;
    # then K6, K7 and forward+backward on the same lanes
    sc = big_cuda["spheres"]
    n_big = 1 << 20
    o, d = pixel_centre_rays(sc, n_big)
    tables = kbs.pack_big_tables(sc, bcfg)
    tracer = kbs.make_bigscene_tracer(sc, bcfg)
    k5_ms, k5 = cuda_time_ms(lambda: tracer(sc, o, d, 7), 3)
    plain_k5_ms, ref = once_ms(
        lambda: kbs.trace_lanes_plain(tables, bcfg, o, d, 7))
    share, mabs, _ = compare(k5, ref, f"K5 spheres {n_big} lanes")
    err_k5 = max(err_k5, mabs)
    del ref
    k6_ms, (k6, resf, resi) = cuda_time_ms(
        lambda: kbs.trace_lanes(tables, bcfg, o, d, 7, residual=True), 3)
    if not torch.equal(k5, k6):
        raise AssertionError("K6's radiance is not K5's bit for bit at 1M "
                             "lanes")
    g = torch.full((n_big, 3), 1.0 / n_big, device="cuda")
    k7_ms, grads = cuda_time_ms(
        lambda: kbs.bwd_res(tables, bcfg, g, k6, resf, resi), 3)
    if not all(torch.equal(a, b) for a, b in zip(
            grads, kbs.bwd_res(tables, bcfg, g, k6, resf, resi))):
        raise AssertionError("K7's gradient does not repeat bit for bit at "
                             "1M lanes")
    # the same build with the cull off: timed, and equal to the last bit
    off = dataclasses.replace(bcfg, cull="off")
    k5_off_ms, k5_off = cuda_time_ms(
        lambda: kbs.trace_lanes(tables, off, o, d, 7), 3)
    same_bits(k5, k5_off, "K5 against cull='off' at 1M lanes")
    k6_off_ms, k6_off = cuda_time_ms(
        lambda: kbs.trace_lanes(tables, off, o, d, 7, residual=True), 3)
    same_bits((k6, resf, resi), k6_off, "K6 against cull='off' at 1M lanes")
    del k5_off, k6_off
    # where K7's time goes: its device kernels, the longest first
    k7_split = kernel_split(lambda: kbs.bwd_res(tables, bcfg, g, k6, resf,
                                                resi), top=8)
    # the sums by tag on K7's row tags and planes at these lanes: the card's
    # sort and split sums against their plain versions, timed
    tag_k7 = check_tag_sums(recorded_tag_sets(
        lambda: kbs.bwd_res(tables, bcfg, g, k6, resf, resi)),
        f"K7's rows, spheres {n_big} lanes")
    plain_k6_ms, (ref_l, ref_f, ref_i) = once_ms(
        lambda: kbs.trace_lanes_plain(tables, bcfg, o, d, 7, residual=True))
    plain_k7_ms, ref_g = once_ms(
        lambda: kbs.bwd_res_plain(tables, bcfg, g, ref_l, ref_f, ref_i))
    share6, mabs6, _ = compare(k6, ref_l, f"K6 spheres {n_big} lanes")
    cerr = compare_cache(resf, resi, ref_f, ref_i, f"K6 cache {n_big} lanes")
    gerr = compare_grads(grads, ref_g, f"K7 spheres {n_big} lanes")
    err_k6, err_k7 = max(err_k6, mabs6, cerr), max(err_k7, gerr)
    big_cache = resf.numel() * 4 + resi.numel() * 4
    res_n = resf.shape[0]
    ops5 = k5_ops(tables, resf, bcfg)
    ops8 = k8_ops(tables, resf, bcfg)
    # the culled count: K5's work with each sweep culled by the lane's own
    # walk; K8 adds its adjoint terms to it
    walk = {}
    w_rows, w_sweeps, w_bounds, *_ = swept_counts(tables, bcfg, o, d, 7,
                                                  stats=walk)
    del walk["plain"]   # the peaks below hold their own cache, not this
    ops5c, ops8c = walk["ops"], walk["ops"] + (ops8 - ops5)
    # the forward+backward's peak holds its own cache, not these
    del ref_l, ref_f, ref_i, ref_g, k6, resf, resi
    leaves = [t.clone().requires_grad_() for t in
              (sc.mat_diffuse, sc.mat_specular, sc.emission,
               sc.env_radiance_)]
    big_diff = kbs.make_bigscene_diff_tracer(sc, bcfg)

    def big_fwd_bwd():
        for t in leaves:
            t.grad = None
        loss = big_diff(*leaves, o, d, 7).sum() / n_big
        loss.backward()
        return loss

    bfb_ms, _ = cuda_time_ms(big_fwd_bwd, 3)
    torch.cuda.reset_peak_memory_stats()
    big_fwd_bwd()
    torch.cuda.synchronize()
    big_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(torch.equal(a, t.grad) for a, t in zip(grads, leaves)):
        raise AssertionError("the big-scene diff tracer's gradient is not "
                             "K7's")
    # K8, the replay backward, on the same lanes and gradient, and the
    # replay path: K5 forward, K8 backward
    k8_ms, k8 = cuda_time_ms(
        lambda: kbs.bwd_replay(tables, bcfg, o, d, 7, None, None, g, k5), 3)
    if not all(torch.equal(a, b) for a, b in zip(
            k8, kbs.bwd_replay(tables, bcfg, o, d, 7, None, None, g, k5))):
        raise AssertionError("K8's gradient does not repeat bit for bit at "
                             "1M lanes")
    plain_k8_ms, ref_g8 = once_ms(lambda: kbs.sums_plain(
        tables, bcfg, *kbs.bwd_replay_plain(tables, bcfg, o, d, 7, None, None,
                                            g, k5)))
    rerr8 = compare_grads(k8, ref_g8, f"K8 spheres {n_big} lanes")
    k8_off_ms, k8_off = cuda_time_ms(
        lambda: kbs.bwd_replay(tables, off, o, d, 7, None, None, g, k5), 3)
    same_bits(tuple(k8), tuple(k8_off), "K8 against cull='off' at 1M lanes")
    del k8_off
    xerr8 = compare_grads(k8, grads, f"K8 vs K7 spheres {n_big} lanes",
                          CROSS_RTOL, CROSS_ATOL)
    err_k8 = max(err_k8, rerr8)
    del ref_g8
    k8_split = kernel_split(lambda: kbs.bwd_replay(tables, bcfg, o, d, 7,
                                                   None, None, g, k5), top=8)
    tag_k8 = check_tag_sums(recorded_tag_sets(
        lambda: kbs.bwd_replay(tables, bcfg, o, d, 7, None, None, g, k5)),
        f"K8's rows, spheres {n_big} lanes")
    print(f"profile: K7 {k7_split}; K8 {k8_split}", flush=True)
    big_replay = kbs.make_bigscene_diff_tracer(sc, bcfg, backward="replay")

    def big_fwd_bwd_replay():
        for t in leaves:
            t.grad = None
        loss = big_replay(*leaves, o, d, 7).sum() / n_big
        loss.backward()
        return loss

    torch.cuda.synchronize()
    reset_big()
    bfr_ms, _ = cuda_time_ms(big_fwd_bwd_replay, 3)
    big_replay_launches = big_counts()
    take_tags("the big-scene replay path")
    if big_replay_launches[0] == 0 or big_replay_launches[3] == 0 or \
            big_replay_launches[1:3] != (0, 0):
        raise AssertionError(f"the big-scene replay path launched K5/K6/K7/K8 "
                             f"{big_replay_launches}")
    torch.cuda.reset_peak_memory_stats()
    big_fwd_bwd_replay()
    torch.cuda.synchronize()
    big_replay_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(torch.equal(a, t.grad) for a, t in zip(k8, leaves)):
        raise AssertionError("the big-scene replay tracer's gradient is not "
                             "K8's")
    m_rows = int(sc.mat_kind.shape[0])
    n_l = len(tables.static["lights"])
    bounds["K5"] = bound_ms(n_big * (24 + 12), ops5c)
    bounds["K6"] = bound_ms(n_big * (24 + 12) + big_cache, ops5c)
    full_bounds = {"K5": bound_ms(n_big * (24 + 12), ops5),
                   "K6": bound_ms(n_big * (24 + 12) + big_cache, ops5)}
    # K7 reads the cache, g and L and writes the (M, 10) tables; its
    # arithmetic is K3's per lane-bounce
    bounds["K7"] = bound_ms(big_cache + n_big * 24 + m_rows * 10 * 4,
                            float(n_big * (bcfg.max_depth * (45 + 27 * n_l)
                                           + 6)))
    # K8 reads the rays, g and L and writes the (M, 9) tables (its row-tagged
    # planes are its own scratch, not the function's bytes)
    PB = 9
    bounds["K8"] = bound_ms(n_big * (24 + 12 + 12) + m_rows * PB * 4, ops8c)
    full_bounds["K8"] = bound_ms(n_big * (24 + 12 + 12) + m_rows * PB * 4,
                                 ops8)
    # the mesh's K5 on its 1M pixel-centre lanes, culled and not
    msc = big_cuda["mesh"]
    mo, md = pixel_centre_rays(msc, n_big)
    mtab = kbs.pack_big_tables(msc, bcfg)
    mk5_ms, mk5 = cuda_time_ms(lambda: kbs.trace_lanes(mtab, bcfg, mo, md, 7),
                               3)
    mk5_off_ms, mk5_off = cuda_time_ms(
        lambda: kbs.trace_lanes(mtab, off, mo, md, 7), 3)
    same_bits(mk5, mk5_off, "mesh K5 against cull='off' at 1M lanes")
    mwalk = {}
    m_rows, m_sweeps, m_bounds, *_ = swept_counts(mtab, bcfg, mo, md, 7,
                                                  stats=mwalk)
    del mwalk["plain"]
    m_bound = bound_ms(n_big * (24 + 12), mwalk["ops"])
    del mk5, mk5_off, mo, md
    print(f"timing: spheres 1026 surfaces, depth 3, {n_big} pixel-centre "
          f"lanes (benchmarks/run.py): K5 {k5_ms:.3f} ms "
          f"({n_big / k5_ms / 1e3:.2f} Mrays/s), plain K5 {plain_k5_ms:.1f} "
          f"ms; K5 vs plain {share:.5f} of lanes outside (max |err| "
          f"{mabs:.3g}); on {smi}", flush=True)
    print(f"big fwd+bwd: the same lanes, loss = out.sum() / N through "
          f"make_bigscene_diff_tracer: {bfb_ms:.3f} ms, peak memory "
          f"{big_peak_gb:.3f} GB allocated (rays included); K6 {k6_ms:.3f} "
          f"ms, K7 {k7_ms:.3f} ms (its lane pass, the sort of the row tags "
          f"and the sums by row); plain K6 {plain_k6_ms:.1f} ms, plain K7 "
          f"{plain_k7_ms:.1f} ms; cache {res_n} float + "
          f"{bcfg.max_depth + 1} int planes = {big_cache / 1e9:.4f} GB; K6 vs "
          f"plain {share6:.5f} of lanes outside (max |err| {mabs6:.3g}), "
          f"cache max |err| {cerr:.3g}, K7 max |err| {gerr:.3g}, repeats bit "
          f"for bit; the tracer's gradient = K7's bit for bit; on {smi}",
          flush=True)
    print(f"big replay: the same lanes and loss through make_bigscene_diff_"
          f"tracer(backward=\"replay\"): {bfr_ms:.3f} ms, peak memory "
          f"{big_replay_peak_gb:.3f} GB allocated (the residual path's "
          f"{big_peak_gb:.3f} GB); launches K5/K6/K7/K8 {big_replay_launches}; "
          f"K8 {k8_ms:.3f} ms (the replay kernel, the sort of the row tags "
          f"and the sums by row), plain K8 {plain_k8_ms:.1f} ms; the "
          f"tracer's gradient = K8's bit for bit; K8 vs plain max |err| "
          f"{rerr8:.3g}, repeats bit for bit; K8 vs K7 within rtol="
          f"{CROSS_RTOL}/atol={CROSS_ATOL} (max |diff| {xerr8:.3g}); on {smi}",
          flush=True)
    print(f"cull: spheres {n_big} lanes: "
          f"with cull={bcfg.cull!r} K5 {k5_ms:.3f} ms, K6 {k6_ms:.3f} ms, K8 "
          f"{k8_ms:.3f} ms; the same build with cull='off' K5 {k5_off_ms:.3f}"
          f" ms, K6 {k6_off_ms:.3f} ms, K8 {k8_off_ms:.3f} ms, equal to the "
          f"last bit; the tree walk (from the plain run's rays) "
          f"{w_rows / w_sweeps:.1f} rows and {w_bounds / w_sweeps:.1f} node "
          f"steps of the warp a lane-sweep; on {smi}", flush=True)
    print(f"cull: mesh (1282 surfaces) {n_big} pixel-centre lanes, depth 3: "
          f"K5 {mk5_ms:.3f} ms, cull='off' {mk5_off_ms:.3f} ms, equal to "
          f"the last bit; culled bound {m_bound[0]:.4f} ms by {m_bound[1]} "
          f"(ops {mwalk['ops']:.4g}); the tree walk {m_rows / m_sweeps:.1f} "
          f"rows and {m_bounds / m_sweeps:.1f} node steps of the warp a "
          f"lane-sweep", flush=True)
    for k in ("K5", "K6", "K7", "K8"):
        full = (f", full sweep {full_bounds[k][0]:.4f} ms by "
                f"{full_bounds[k][1]}" if k in full_bounds else "")
        print(f"bound: {k} {bounds[k][0]:.4f} ms by {bounds[k][1]} (culled K5 "
              f"ops {ops5c:.4g}, K8 ops {ops8c:.4g}; full-sweep K5 ops "
              f"{ops5:.4g}, K8 ops {ops8:.4g}; cache {big_cache:.4g} B"
              f"{full})", flush=True)
    del k5, grads, g, leaves, o, d, k8

    # 9e. training past 64 surfaces through make_train_step (K6, K7)
    true_b = big["spheres"]
    tcfg = kwf.KernelConfig(max_depth=3, sampler="hash")
    target = render(true_b, spp=64, seed=99, cfg=tcfg, clamp=False)
    spheres = slice(1, m_rows - 1)   # not the ground (row 0) or the light
    dif0 = true_b.mat_diffuse.clone()
    dif0[spheres] = dif0[spheres] * 0.4
    start = dataclasses.replace(true_b, mat_diffuse=dif0)
    step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                      kernel_sampler="hash")

    def sphere_err():
        return float((params["mat_diffuse"].detach().cpu()[spheres]
                      - true_b.mat_diffuse[spheres]).abs().mean())

    err0 = sphere_err()
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    reset_big()
    for i in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(key)))
        walls.append((time.perf_counter() - t0) * 1e3)
    big_train_launches = big_counts()
    take_tags("the big-scene train step")
    if big_train_launches[1] == 0 or big_train_launches[2] == 0 or \
            big_train_launches[3] != 0 or counts() != (0, 0, 0, 0):
        raise AssertionError(f"the big-scene train step launched K5/K6/K7 "
                             f"{big_train_launches} and K1-K4 {counts()}")
    err5 = sphere_err()
    if not (np.isfinite(losses).all() and np.all(np.diff(losses) < 0)
            and err5 < err0):
        raise AssertionError(f"the loss did not fall: {losses}, mean "
                             f"|diffuse - true| {err0} -> {err5}")
    if not all(bool((p >= 0).all()) for p in params.values()):
        raise AssertionError("a parameter went negative")
    bstep_ms = float(np.median(walls[1:]))
    print(f"big train: spheres 1026 surfaces 256x256, 4 spp, depth 3, hash, "
          f"the spheres' diffuse scaled by 0.4: losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; mean |diffuse - true| "
          f"over the spheres {err0:.5f} -> {err5:.5f}; {bstep_ms:.3f} ms a "
          f"step (median of steps 2-5; all: "
          f"{', '.join(f'{v:.1f}' for v in walls)}); launches K5/K6/K7 "
          f"{big_train_launches}, K1-K4 {counts()}", flush=True)
    busy, mine, n_k = device_profile(
        lambda: step(key), {"K6": K6_NAMES, "K7": K7_NAMES})
    print(f"profile: big train step: device busy {busy:.3f} ms in {n_k} "
          f"kernels (idle share {1 - busy / bstep_ms:.3f} of the median "
          f"step); K6 {mine['K6']:.3f} ms, K7 {mine['K7']:.3f} ms = "
          f"{(mine['K6'] + mine['K7']) / busy:.3f} of device busy time",
          flush=True)
    with recording(kbs) as seen:
        step(key)
        torch.cuda.synchronize()
    e6, e7 = check_recorded_step(kbs, seen, "big train step",
                                 ("K5", "K6", "K7"))
    err_k6, err_k7 = max(err_k6, e6), max(err_k7, e7)

    # 10. textures through K1-K4: kytpu's checker floor and back-wall images
    from kytpu_torch.diff.params import get_params, set_params
    rng = np.random.default_rng(4)
    tex_scenes = {
        "checker": builders.cornell_box(width=256, height=256,
                                        floor_checker=True),
        "select": builders.cornell_box(width=256, height=256, back_image=rng
                                       .uniform(0.1, 0.9, (8, 8, 3))
                                       .astype(np.float32)),
        "separable": builders.cornell_box(width=256, height=256,
                                          floor_checker=True,
                                          back_image=demo_texture(16))}
    # 10a. each textured kernel against its plain version, 64K lanes
    tex_cases = [("checker", "random", "all", "parity", False),
                 ("select", "hash", "all", "robust", True),
                 ("separable", "sobol", "single", "parity", False),
                 ("separable", "hash", "all", "parity", True)]
    for sc_name, sampler, nee, shadow, texp in tex_cases:
        scene = tex_scenes[sc_name].to("cuda")
        cfg = kwf.KernelConfig(max_depth=5, sampler=sampler, nee=nee,
                               shadow=shadow, trainable_exponent=texp)
        tag = f"textured {sc_name} {sampler}/{nee}/{shadow}" + (
            " trainable exponent" if texp else "")
        o, d, si, pix = jittered_rays(scene, 1 << 16, 19)
        tables = kwf.pack_tables(scene, cfg)
        before = counts()
        k1 = kwf.trace_lanes(tables, cfg, o, d, 41, si, pix)
        k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 41, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
        k3 = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        k4 = kwf.bwd_replay(tables, cfg, o, d, 41, si, pix, g, k1)
        torch.cuda.synchronize()
        if counts() != (before[0] + 1, before[1] + 1, before[2] + 1,
                        before[3] + 1):
            raise AssertionError(f"{tag}: K1-K4 did not launch")
        if not torch.equal(k1, k2):
            raise AssertionError(f"{tag}: K2's radiance is not K1's")
        for nm, got, again in (
                ("K3", k3, kwf.bwd_res(tables, cfg, g, k2, resf, resi)),
                ("K4", k4, kwf.bwd_replay(tables, cfg, o, d, 41, si, pix, g,
                                          k1))):
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: {nm} does not repeat")
        ref1 = kwf.trace_lanes_plain(tables, cfg, o, d, 41, si, pix)
        ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 41, si,
                                                    pix, residual=True)
        share, mabs, _ = compare(k1, ref1, f"K1 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K2 cache {tag}")
        same_bits(k1, ref1, f"K1 {tag}")
        same_bits((k2, resf, resi), (ref_l, ref_f, ref_i), f"K2 {tag}")
        gerr = compare_grads(k3, kwf.bwd_res_plain(tables, cfg, g, ref_l,
                                                   ref_f, ref_i), f"K3 {tag}")
        rerr = compare_grads(k4, kwf.bwd_replay_plain(
            tables, cfg, o, d, 41, si, pix, g, ref1), f"K4 {tag}")
        xerr = compare_grads(k4, k3, f"K4 vs K3 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        max_abs_err = max(max_abs_err, mabs)
        err_res, err_bwd = max(err_res, cerr), max(err_bwd, gerr)
        err_replay = max(err_replay, rerr)
        tex = [float(t.abs().max()) for t in k3[4 + texp:]]
        print(f"textured kernels vs plain: {tag}: {o.shape[0]} lanes, depth "
              f"5: K1 and K2 (radiance, cache) = plain bit for bit; "
              f"K1 {share:.5f} of lanes outside (max |err| {mabs:.3g}); K2 "
              f"radiance = K1's bit for bit, cache {resf.shape[0]}+"
              f"{resi.shape[0]} planes (max |err| {cerr:.3g}); K3 (max |err| "
              f"{gerr:.3g}) and K4 (max |err| {rerr:.3g}) within the bound, "
              f"repeat bit for bit; K4 vs K3 within rtol={CROSS_RTOL}/atol="
              f"{CROSS_ATOL} (max |diff| {xerr:.3g}); largest texture "
              f"adjoints (dta, dtb[, dti]) {', '.join(f'{v:.3g}' for v in tex)}",
              flush=True)
        if not any(v > 0 for v in tex):
            raise AssertionError(f"{tag}: no texture adjoint")
    del k1, k2, k3, k4, resf, resi, ref1, ref_l, ref_f, ref_i

    # 10b. kytpu's textured render: Cornell 512x512, a checker floor and a
    # 32x32 painted back wall, 64 spp through render() (the main path: K1)
    tex_frame = builders.cornell_box(builders.DEFAULT_SCENE, 512, 512,
                                     floor_checker=True,
                                     back_image=demo_texture(32))

    def tframe(n_spp):
        return render(tex_frame, spp=n_spp, seed=seed, clamp=False)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = tframe(spp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tex_render_launches = counts()
    a = img.cpu().numpy()
    if tex_render_launches[0] == 0 or tex_render_launches[1:] != (0, 0, 0) \
            or a.shape != (512, 512, 3) or not np.isfinite(a).all() \
            or (a < 0).any():
        raise AssertionError(f"textured frame: launches {tex_render_launches}")
    tcfg = kwf.KernelConfig()
    tex_tables = kwf.pack_tables(tex_frame.to("cuda"), tcfg)
    ref = kwf.render_cuda(
        tex_frame.to("cuda"), spp=4, seed=seed, cfg=tcfg, clamp=False,
        rays_per_pass=1 << 20,
        tracer=lambda s, o, d, *args: kwf.trace_lanes_plain(
            tex_tables, tcfg, o, d, *args))
    share, mabs, _ = compare(tframe(4).reshape(-1, 3), ref.reshape(-1, 3),
                             "textured 4-spp frame")
    max_abs_err = max(max_abs_err, mabs)
    del ref
    tframe(spp)   # warm
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tframe(spp)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    busy, mine, n_k = device_profile(lambda: tframe(spp), {"K1": K1_NAMES})
    print(f"textured frame: cornell 512x512, checker floor, 32x32 back wall, "
          f"{spp} spp in {secs:.3f} s (cold), mean {a.mean():.5f}; launches "
          f"K1/K2/K3/K4 {tex_render_launches}; the 4-spp frame against the "
          f"plain K1: {share:.5f} of pixels outside the bound, max |err| "
          f"{mabs:.3g}", flush=True)
    print(f"profile: textured frame {spp} spp: wall {wall:.3f} ms (median of "
          f"5 warmed frames: {min(walls):.3f}-{max(walls):.3f}); device busy "
          f"{busy:.3f} ms in {n_k} kernels (idle share {1 - busy / wall:.3f});"
          f" wavefront_fwd {mine['K1']:.3f} ms = {mine['K1'] / busy:.3f} of "
          f"device busy time, {mine['K1'] / wall:.3f} of wall; on {smi}",
          flush=True)

    # 10c, 10d. texture recovery: five steps of the texels of a 16x16 back
    # wall from a flat 0.5 grey, then five of the checker colours from 0.4
    # of the truth; Cornell 256x256, 4 spp, depth 3, hash, one key
    tex_train = {}
    for what, names, true_sc in (
            ("texels", ("tex_image",), tex_scenes["separable"]),
            ("checker", ("tex_color_a", "tex_color_b"),
             tex_scenes["checker"])):
        tcfg = kwf.KernelConfig(max_depth=3, sampler="hash")
        target = render(true_sc, spp=64, seed=99, cfg=tcfg, clamp=False)
        true_p = get_params(true_sc, names)
        start = set_params(true_sc, {
            n: (torch.full_like(v, 0.5) if n == "tex_image" else v * 0.4)
            for n, v in true_p.items()})
        step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                          kernel_sampler="hash", names=names)

        def tex_err():
            return sum(float((params[n].detach().cpu() - true_p[n])
                             .abs().mean()) for n in names)

        err0 = tex_err()
        losses, walls = [], []
        torch.cuda.synchronize()
        reset_counts()
        for i in range(5):
            t0 = time.perf_counter()
            losses.append(float(step(key)))
            walls.append((time.perf_counter() - t0) * 1e3)
        tl = counts()
        take_tags(f"{what} recovery", need=what == "texels")
        err5 = tex_err()
        # the texels' error must fall; the checker colours' loss
        if tl[1] == 0 or tl[2] == 0 or not (
                np.isfinite(losses).all() and losses[-1] < losses[0]
                and (err5 < err0 or what == "checker")):
            raise AssertionError(f"{what} recovery: losses {losses}, error "
                                 f"{err0} -> {err5}, launches {tl}")
        tstep_ms = float(np.median(walls[1:]))
        busy, mine, n_k = device_profile(lambda: step(key),
                                         {"K2": K2_NAMES, "K3": K3_NAMES})
        print(f"texture train: {what} ({', '.join(names)}), cornell "
              f"256x256, 4 spp, depth 3, hash: losses "
              f"{', '.join(f'{v:.6f}' for v in losses)}; mean |texture - "
              f"true| {err0:.5f} -> {err5:.5f}; {tstep_ms:.3f} ms a step "
              f"(median of steps 2-5; all: "
              f"{', '.join(f'{v:.1f}' for v in walls)}); launches K1/K2/K3/K4 "
              f"{tl}; profile: device busy {busy:.3f} ms in {n_k} kernels "
              f"(idle share {1 - busy / tstep_ms:.3f}), K2 {mine['K2']:.3f} "
              f"ms, K3 {mine['K3']:.3f} ms", flush=True)
        with recording(kwf) as seen:
            step(key)
            torch.cuda.synchronize()
        e2, e3 = check_recorded_step(kwf, seen, f"{what} train step")
        err_res, err_bwd = max(err_res, e2), max(err_bwd, e3)
        tex_train[what] = tl

    # 10e. the textured replay path: make_cuda_diff_tracer(backward=
    # "replay") on the texel scene, 1M lanes at depth 3, its gradient K4's
    scene = tex_scenes["separable"].to("cuda")
    rcfg = kwf.KernelConfig(max_depth=3)
    o, d, _, _ = jittered_rays(scene, 1 << 20, 23)
    tx = scene.textures
    leaves = [t.clone().requires_grad_() for t in (
        scene.mat_diffuse, scene.mat_specular, scene.emission, tx.color_a,
        tx.color_b, tx.image)]
    env0 = torch.zeros(3, device="cuda")
    tex_replay = kwf.make_cuda_diff_tracer(scene, rcfg, backward="replay")
    reset_counts()
    out = tex_replay(*leaves, env0, o, d, 13)
    (out.sum() / out.shape[0]).backward()
    torch.cuda.synchronize()
    tex_replay_launches = counts()
    take_tags("the textured replay path")
    if tex_replay_launches != (1, 0, 0, 1):
        raise AssertionError(f"the textured replay path launched K1-K4 "
                             f"{tex_replay_launches}")
    tabs = kwf.pack_tables(scene, rcfg)
    g = torch.full_like(out, 1.0 / out.shape[0])
    k4 = kwf.bwd_replay(tabs, rcfg, o, d, 13, None, None, g, out.detach())
    if not all(torch.equal(t.grad.reshape(a.shape), a)
               for t, a in zip(leaves, k4[:3] + k4[4:])):
        raise AssertionError("the textured replay tracer's gradient is not "
                             "K4's")
    k4_tex_ms, _ = cuda_time_ms(lambda: kwf.bwd_replay(
        tabs, rcfg, o, d, 13, None, None, g, out.detach()), 3)
    print(f"textured replay: cornell 256x256 with a 16x16 back wall and a "
          f"checker floor, {o.shape[0]} lanes, depth 3, through "
          f"make_cuda_diff_tracer(backward=\"replay\"): launches K1/K2/K3/K4 "
          f"{tex_replay_launches}, the tracer's gradient = K4's bit for bit "
          f"(dti max {float(k4[-1].abs().max()):.3g}); K4 {k4_tex_ms:.3f} ms",
          flush=True)
    del o, d, out, leaves, k4, g

    # 11. past 64 surfaces on every route (kytpu's rule): the textured
    # table kernels K5-K8, K1-K4 on a scene the tables refuse, smallpt
    from kytpu_torch.scene import texture as ktex

    def ground_textured(sc, tex):
        """sc with texture `tex` on its ground, row 0 (random_spheres'
        ground rect)."""
        tid = torch.full((int(sc.mat_kind.shape[0]),), -1, dtype=torch.int32)
        tid[0] = 0
        return dataclasses.replace(sc, has_textures=True, tex_id=tid,
                                   textures=ktex.build([tex]))

    rng = np.random.default_rng(6)
    spheres_b = big["spheres"]
    past64 = {
        "checker": ground_textured(spheres_b, dict(
            kind=ktex.CHECKER, color_a=np.float32([0.85, 0.3, 0.25]),
            color_b=np.float32([0.2, 0.7, 0.35]), scale=(16.0, 16.0))),
        "select": ground_textured(spheres_b, dict(
            kind=ktex.IMAGE, image=rng.uniform(0.1, 0.9, (8, 8, 3)).astype(
                np.float32), scale=(4.0, 4.0))),
        "separable": ground_textured(spheres_b, dict(
            kind=ktex.IMAGE, image=demo_texture(16), scale=(4.0, 4.0)))}
    for nm, sc in past64.items():
        try:
            kbs.extract_tables(sc)
            route = "K5-K8 (TEX)"
        except NotImplementedError as e:
            route = f"K1-K4 (the tables refuse it: {e})"
        print(f"past 64: spheres 1026 surfaces with a {nm} ground: routes to "
              f"{route}", flush=True)
    p64_cuda = {nm: sc.to("cuda") for nm, sc in past64.items()}

    # 11a. the textured K5-K8 against their plain versions, 64K lanes
    tex_big_cases = [("checker", "random", "parity", False),
                     ("checker", "sobol", "robust", True),
                     ("select", "hash", "robust", False),
                     ("select", "sobol", "parity", True)]
    for sc_name, sampler, shadow, texp in tex_big_cases:
        scene = p64_cuda[sc_name]
        cfg = kwf.KernelConfig(max_depth=3, sampler=sampler, shadow=shadow,
                               trainable_exponent=texp)
        tag = f"textured spheres {sc_name} {sampler}/{shadow}" + (
            " trainable exponent" if texp else "")
        o, d, si, pix = jittered_rays(scene, 1 << 16, 29)
        tables = kbs.pack_big_tables(scene, cfg)
        before = big_counts()
        k5 = kbs.trace_lanes(tables, cfg, o, d, 43, si, pix)
        k6, resf, resi = kbs.trace_lanes(tables, cfg, o, d, 43, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
        k7 = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
        k8 = kbs.bwd_replay(tables, cfg, o, d, 43, si, pix, g, k5)
        torch.cuda.synchronize()
        if big_counts() != (before[0] + 1, before[1] + 1, before[2] + 1,
                            before[3] + 1):
            raise AssertionError(f"{tag}: K5-K8 did not launch")
        if not torch.equal(k5, k6):
            raise AssertionError(f"{tag}: K6's radiance is not K5's")
        for nm, got, again in (
                ("K7", k7, kbs.bwd_res(tables, cfg, g, k6, resf, resi)),
                ("K8", k8, kbs.bwd_replay(tables, cfg, o, d, 43, si, pix, g,
                                          k5))):
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: {nm} does not repeat")
        same_as_cull_off(tables, cfg, (o, d, 43, si, pix), g,
                         (k5, (k6, resf, resi), k8), tag)
        ref_l, ref_f, ref_i = kbs.trace_lanes_plain(
            tables, cfg, o, d, 43, si, pix, residual=True)
        share, mabs, _ = compare(k5, ref_l, f"K5 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K6 cache {tag}")
        gerr = compare_grads(k7, kbs.bwd_res_plain(tables, cfg, g, ref_l,
                                                   ref_f, ref_i), f"K7 {tag}")
        rerr = compare_grads(k8, kbs.sums_plain(tables, cfg, *kbs.bwd_replay_plain(
            tables, cfg, o, d, 43, si, pix, g, k5)), f"K8 {tag}")
        xerr = compare_grads(k8, k7, f"K8 vs K7 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        err_k5, err_k6 = max(err_k5, mabs), max(err_k6, mabs, cerr)
        err_k7, err_k8 = max(err_k7, gerr), max(err_k8, rerr)
        tex = [float(t.abs().max()) for t in k7[4 + texp:]]
        # a checker's colours, or an atlas's texels
        if not (min(tex) if sc_name == "checker" else tex[-1]) > 0:
            raise AssertionError(f"{tag}: no texture adjoint {tex}")
        print(f"textured big kernels vs plain: {tag}: {o.shape[0]} lanes, "
              f"depth 3: K5 {share:.5f} of lanes outside (max |err| "
              f"{mabs:.3g}); K6 radiance = K5's bit for bit, cache "
              f"{resf.shape[0]}+{resi.shape[0]} planes (max |err| {cerr:.3g});"
              f" K7 (max |err| {gerr:.3g}) and K8 (max |err| {rerr:.3g}) "
              f"within the bound, repeat bit for bit; K8 vs K7 within rtol="
              f"{CROSS_RTOL}/atol={CROSS_ATOL} (max |diff| {xerr:.3g}); "
              f"K5, K6 and K8 with cull={cfg.cull!r} = cull='off' bit for "
              f"bit; largest texture adjoints (dta, dtb[, dti]) "
              f"{', '.join(f'{v:.3g}' for v in tex)}", flush=True)
    del k5, k6, k7, k8, resf, resi, ref_l, ref_f, ref_i
    # the textured K5 against K1 on the textured Cornell box
    tcorn = builders.cornell_box(width=256, height=256, floor_checker=True,
                                 back_image=rng.uniform(0.1, 0.9, (8, 8, 3))
                                 .astype(np.float32)).to("cuda")
    cfg = kwf.KernelConfig(max_depth=5)
    o, d, _, _ = jittered_rays(tcorn, n_lanes, 31)
    k1 = kwf.trace_lanes(kwf.pack_tables(tcorn, cfg), cfg, o, d, 37)
    k5 = kbs.trace_lanes(kbs.pack_big_tables(tcorn, cfg), cfg, o, d, 37)
    within = float(((k5 - k1).abs() <= 1e-3).all(-1).float().mean())
    if within < 1 - MAX_BAD_SHARE:
        raise AssertionError(f"textured K5 vs K1: only {within:.5f} of lanes "
                             "within 1e-3")
    print(f"textured K5 vs K1: cornell 256x256 with a checker floor and an "
          f"8x8 back wall, depth 5, {n_lanes} lanes: {within:.5f} of lanes "
          f"within 1e-3 (max |diff| {float((k5 - k1).abs().max()):.3g})",
          flush=True)
    del k1, k5

    # 11b. a 16-spp textured frame past 64 surfaces through render(): K5
    reset_counts()
    reset_big()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(past64["checker"], spp=big_spp, seed=seed, cfg=bcfg,
                 clamp=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tex_big_launches = big_counts()
    if tex_big_launches[0] == 0 or tex_big_launches[1:] != (0, 0, 0) or \
            counts() != (0, 0, 0, 0):
        raise AssertionError(f"the textured big frame launched K5-K8 "
                             f"{tex_big_launches} and K1-K4 {counts()}")
    tables = kbs.pack_big_tables(p64_cuda["checker"], bcfg)
    ref = kwf.render_cuda(p64_cuda["checker"], spp=big_spp, seed=seed,
                          cfg=bcfg, clamp=False, rays_per_pass=1 << 20,
                          tracer=lambda s, o, d, *args: kbs.trace_lanes_plain(
                              tables, bcfg, o, d, *args))
    share, mabs, _ = compare(img.reshape(-1, 3), ref.reshape(-1, 3),
                             "textured big frame")
    err_k5 = max(err_k5, mabs)
    print(f"frame: spheres with a checker ground 256x256 {big_spp} spp, depth "
          f"3 in {secs:.3f} s (cold), mean {float(img.mean()):.5f}; launches "
          f"K5/K6/K7/K8 {tex_big_launches}, K1-K4 {counts()}; against the "
          f"same frame through the plain K5: {share:.5f} of pixels outside "
          f"the bound, max |err| {mabs:.3g}", flush=True)
    del img, ref

    def tex_big_frame():
        return render(past64["checker"], spp=big_spp, seed=seed, cfg=bcfg,
                      clamp=False)

    tex_big_frame()   # warm
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tex_big_frame()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    busy, mine, n_k = device_profile(tex_big_frame, {"K5": K5_NAMES})
    print(f"profile: textured spheres frame, {big_spp} spp: wall {wall:.3f} ms "
          f"(median of 5 warmed frames: {min(walls):.3f}-{max(walls):.3f}); "
          f"device busy {busy:.3f} ms in {n_k} kernels (idle share "
          f"{1 - busy / wall:.3f}); bigscene_fwd {mine['K5']:.3f} ms = "
          f"{mine['K5'] / busy:.3f} of device busy time", flush=True)

    # 11c. checker-colour recovery past 64 surfaces: K6, K7 with TEX
    names = ("tex_color_a", "tex_color_b")
    tcfg = kwf.KernelConfig(max_depth=3, sampler="hash")
    target = render(past64["checker"], spp=64, seed=99, cfg=tcfg,
                    clamp=False)
    true_p = get_params(past64["checker"], names)
    start = set_params(past64["checker"],
                       {n: v * 0.4 for n, v in true_p.items()})
    step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                      kernel_sampler="hash", names=names)
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    reset_big()
    for i in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(key)))
        walls.append((time.perf_counter() - t0) * 1e3)
    tex_big_train = big_counts()
    take_tags("the textured big-scene train step")
    if tex_big_train[1] == 0 or tex_big_train[2] == 0 or \
            tex_big_train[3] != 0 or counts() != (0, 0, 0, 0) or not (
                np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"textured big train: losses {losses}, launches "
                             f"K5-K8 {tex_big_train}, K1-K4 {counts()}")
    tb_ms = float(np.median(walls[1:]))
    print(f"textured big train: {', '.join(names)} on the checker-ground "
          f"spheres 256x256, 4 spp, depth 3, hash, from 0.4 of the true "
          f"colours: losses {', '.join(f'{v:.6f}' for v in losses)}; "
          f"{tb_ms:.3f} ms a step (median of steps 2-5); launches K5/K6/K7/K8 "
          f"{tex_big_train}, K1-K4 {counts()}", flush=True)
    with recording(kbs) as seen:
        step(key)
        torch.cuda.synchronize()
    e6, e7 = check_recorded_step(kbs, seen, "textured big train step",
                                 ("K5", "K6", "K7"))
    err_k6, err_k7 = max(err_k6, e6), max(err_k7, e7)

    # 11d. K1-K4 past 64 surfaces: the 16x16 atlas on the ground (a
    # separable atlas, which the tables refuse)
    sep = past64["separable"]
    reset_counts()
    reset_big()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(sep, spp=big_spp, seed=seed, cfg=bcfg, clamp=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sep_render_launches = counts()
    if sep_render_launches[0] == 0 or sep_render_launches[1:] != (0, 0, 0) \
            or big_counts() != (0, 0, 0, 0) or \
            not bool(torch.isfinite(img).all()):
        raise AssertionError(f"the 16x16-ground frame launched K1-K4 "
                             f"{sep_render_launches} and K5-K8 {big_counts()}")
    sep_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(sep, spp=big_spp, seed=seed, cfg=bcfg, clamp=False)
        torch.cuda.synchronize()
        sep_walls.append((time.perf_counter() - t0) * 1e3)
    print(f"frame: spheres with a 16x16 ground atlas 256x256 {big_spp} spp, "
          f"depth 3 in {secs:.3f} s (cold), {float(np.median(sep_walls)):.3f} "
          f"ms warm (median of 3), mean {float(img.mean()):.5f}; launches "
          f"K1/K2/K3/K4 {sep_render_launches}, K5-K8 {big_counts()}",
          flush=True)
    del img
    names = ("tex_image",)
    target = render(sep, spp=64, seed=99, cfg=tcfg, clamp=False)
    true_p = get_params(sep, names)
    start = set_params(sep, {"tex_image": torch.full_like(
        true_p["tex_image"], 0.5)})
    step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                      kernel_sampler="hash", names=names)
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    reset_big()
    for i in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(key)))
        walls.append((time.perf_counter() - t0) * 1e3)
    sep_train = counts()
    take_tags("the 16x16-ground train step")
    if sep_train[1] == 0 or sep_train[2] == 0 or big_counts() != (
            0, 0, 0, 0) or not (np.isfinite(losses).all()
                                and losses[-1] < losses[0]):
        raise AssertionError(f"16x16-ground train: losses {losses}, launches "
                             f"K1-K4 {sep_train}, K5-K8 {big_counts()}")
    print(f"train past 64 on K2/K3: texels of the 16x16 ground from a flat "
          f"0.5 grey, 256x256, 4 spp, depth 3, hash: losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; "
          f"{float(np.median(walls[1:])):.3f} ms a step (median of steps "
          f"2-5); launches K1/K2/K3/K4 {sep_train}, K5-K8 {big_counts()}",
          flush=True)
    with recording(kwf) as seen:
        step(key)
        torch.cuda.synchronize()
    e2, e3 = check_recorded_step(kwf, seen, "16x16-ground train step")
    err_res, err_bwd = max(err_res, e2), max(err_bwd, e3)
    # the row-tagged K3 and K4 against their plain versions, 64K lanes,
    # and against K7 on the untextured twin (random_spheres(1024))
    for sc_name, scene in (("16x16 ground", p64_cuda["separable"]),
                           ("untextured twin", big_cuda["spheres"])):
        cfg = kwf.KernelConfig(max_depth=3, sampler="hash",
                               trainable_exponent=True)
        tag = f"row-tagged K3/K4, spheres {sc_name}, hash, trainable exponent"
        o, d, si, pix = jittered_rays(scene, 1 << 16, 37)
        tables = kwf.pack_tables(scene, cfg)
        if not kwf.row_tagged(tables.static):
            raise AssertionError(f"{tag}: not on the row-tagged route")
        k1 = kwf.trace_lanes(tables, cfg, o, d, 47, si, pix)
        k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 47, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(9))
        k3 = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        k4 = kwf.bwd_replay(tables, cfg, o, d, 47, si, pix, g, k1)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"{tag}: K2's radiance is not K1's")
        for nm, got, again in (
                ("K3", k3, kwf.bwd_res(tables, cfg, g, k2, resf, resi)),
                ("K4", k4, kwf.bwd_replay(tables, cfg, o, d, 47, si, pix, g,
                                          k1))):
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: {nm} does not repeat")
        same_as_cull_off_wf(tables, cfg, (o, d, 47, si, pix), g,
                            (k1, (k2, resf, resi), k4),
                            f"spheres {sc_name}, {o.shape[0]} lanes")
        ref1 = kwf.trace_lanes_plain(tables, cfg, o, d, 47, si, pix)
        ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 47, si,
                                                    pix, residual=True)
        share, mabs, _ = compare(k1, ref1, f"K1 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K2 cache {tag}")
        if tables.stage_bytes:
            raise AssertionError(f"{tag}: the tables were staged")
        same_bits(k1, ref1, f"K1 {tag}, tables in device memory")
        same_bits((k2, resf, resi), (ref_l, ref_f, ref_i),
                  f"K2 {tag}, tables in device memory")
        gerr = compare_grads(k3, kwf.bwd_res_plain(tables, cfg, g, ref_l,
                                                   ref_f, ref_i), f"K3 {tag}")
        rerr = compare_grads(k4, kwf.bwd_replay_plain(
            tables, cfg, o, d, 47, si, pix, g, ref1), f"K4 {tag}")
        xerr = compare_grads(k4, k3, f"K4 vs K3 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        max_abs_err = max(max_abs_err, mabs)
        err_res, err_bwd = max(err_res, cerr), max(err_bwd, gerr)
        err_replay = max(err_replay, rerr)
        rows = kwf.unpack_row(resi) - 1
        live_high = int((k3[0][256:].abs().sum(-1) > 0).sum())
        if int(rows.max()) <= 255 or live_high == 0:
            raise AssertionError(f"{tag}: no live row above 255")
        extra = ""
        if sc_name == "untextured twin":
            btables = kbs.pack_big_tables(scene, cfg)
            k6, bresf, bresi = kbs.trace_lanes(btables, cfg, o, d, 47, si,
                                               pix, residual=True)
            k7 = kbs.bwd_res(btables, cfg, g, k6, bresf, bresi)
            emissive = scene.emission.sum(-1) > 0
            k7e = (*k7[:2], k7[2] * emissive[:, None], *k7[3:])
            k3e = (*k3[:2], k3[2] * emissive[:, None], *k3[3:])
            k4e = (*k4[:2], k4[2] * emissive[:, None], *k4[3:])
            x37 = compare_grads(k3e, k7e, f"K3 vs K7 {tag}", CROSS_RTOL,
                                CROSS_ATOL)
            x47 = compare_grads(k4e, k7e, f"K4 vs K7 {tag}", CROSS_RTOL,
                                CROSS_ATOL)
            extra = (f"; against K7 on the same lanes (d_emission on the "
                     f"emissive rows): K3 max |diff| {x37:.3g}, K4 {x47:.3g}")
        print(f"{tag}: {o.shape[0]} lanes, depth 3, tables in device memory "
              f"({len(tables.static['mats']['kind'])} rows), culled: K1, K2 "
              f"and K4 = cull 'off' bit for bit; K1 and K2 "
              f"(radiance, cache) = plain bit for bit; K1 {share:.5f} of lanes "
              f"outside (max |err| {mabs:.3g}); K2 = K1 bit for bit, cache "
              f"(max |err| {cerr:.3g}), rows up to {int(rows.max())}; K3 (max "
              f"|err| {gerr:.3g}) and K4 (max |err| {rerr:.3g}) within the "
              f"bound, repeat bit for bit; K4 vs K3 max |diff| {xerr:.3g}; "
              f"{live_high} live rows above 255{extra}", flush=True)
    del k1, k2, k3, k4, resf, resi, ref1, ref_l, ref_f, ref_i, k6, k7
    # K1-K4 at the spheres' 1M pixel-centre lanes, 16x16 ground, depth 3
    scene = p64_cuda["separable"]
    o, d = pixel_centre_rays(scene, n_big)
    t0 = time.perf_counter()
    tables = kwf.pack_tables(scene, bcfg)   # the occlusion-skip proofs too
    pack_s = time.perf_counter() - t0
    # K1, K2 and K4 culled (bcfg.cull "cone") and with cull "off", which
    # sweeps every row (step 5 of csrc/wavefront_fwd.cu), in turn
    ocfg = dataclasses.replace(bcfg, cull="off")
    p_k1_ms, k1 = cuda_time_ms(lambda: kwf.trace_lanes(tables, bcfg, o, d, 7),
                               3)
    p_off_ms = {"K1": cuda_time_ms(
        lambda: kwf.trace_lanes(tables, ocfg, o, d, 7), 3)[0]}
    p_k2_ms, (k2, resf, resi) = cuda_time_ms(
        lambda: kwf.trace_lanes(tables, bcfg, o, d, 7, residual=True), 3)
    p_off_ms["K2"] = cuda_time_ms(
        lambda: kwf.trace_lanes(tables, ocfg, o, d, 7, residual=True), 3)[0]
    g = torch.full((n_big, 3), 1.0 / n_big, device="cuda")
    p_k3_ms, k3 = cuda_time_ms(
        lambda: kwf.bwd_res(tables, bcfg, g, k2, resf, resi), 3)
    p_k4_ms, k4 = cuda_time_ms(
        lambda: kwf.bwd_replay(tables, bcfg, o, d, 7, None, None, g, k1), 3)
    p_off_ms["K4"] = cuda_time_ms(
        lambda: kwf.bwd_replay(tables, ocfg, o, d, 7, None, None, g, k1),
        3)[0]
    same_as_cull_off_wf(tables, bcfg, (o, d, 7, None, None), g,
                        (k1, (k2, resf, resi), k4),
                        f"16x16 ground, {n_big} lanes")
    xerr = compare_grads(k4, k3, "K4 vs K3 1M lanes past 64", CROSS_RTOL,
                         CROSS_ATOL)
    # the row-tagged K3 on its shared route and on the local one: the same
    # bits; the sorts and sums by row and texel of K3 and K4 against their
    # plain versions; K3 by device kernel
    if kwf.acc_route(tables, bcfg) != "shared":
        raise AssertionError("the row-tagged K3 is not on the shared route")
    p_k3_local_ms, k3_local = on_route("local", lambda: cuda_time_ms(
        lambda: kwf.bwd_res(tables, bcfg, g, k2, resf, resi), 3))
    same_grads(k3_local, k3, "the row-tagged K3, local vs shared route, 1M "
               "lanes past 64")
    del k3_local
    p3_split = kernel_split(lambda: kwf.bwd_res(tables, bcfg, g, k2, resf,
                                                resi), top=10)
    tag_p64 = check_tag_sums(recorded_tag_sets(
        lambda: kwf.bwd_res(tables, bcfg, g, k2, resf, resi)),
        f"the row-tagged K3's rows and texels, 16x16 ground, {n_big} lanes")
    tag_p64 += check_tag_sums(recorded_tag_sets(
        lambda: kwf.bwd_replay(tables, bcfg, o, d, 7, None, None, g, k1)),
        f"the row-tagged K4's rows and texels, 16x16 ground, {n_big} lanes")
    acc_b = kwf.acc_bytes(tables, bcfg)
    print(f"profile: the row-tagged K3 (shared route, {acc_b} B a block; "
          f"local route {p_k3_local_ms:.3f} ms, the same bits) {p3_split}",
          flush=True)
    # the plain versions once, and the replay path (K1 + K4) through
    # make_cuda_diff_tracer, its launches counted
    p_plain = {}
    p_plain["K1"], ref = once_ms(
        lambda: kwf.trace_lanes_plain(tables, bcfg, o, d, 7))
    _, mabs, _ = compare(k1, ref, "K1 1M lanes past 64")
    same_bits(k1, ref, "K1 1M lanes past 64")
    max_abs_err = max(max_abs_err, mabs)
    p_plain["K2"], ref = once_ms(lambda: kwf.trace_lanes_plain(
        tables, bcfg, o, d, 7, residual=True))
    same_bits((k2, resf, resi), ref, "K2 1M lanes past 64")
    p_plain["K3"], ref = once_ms(
        lambda: kwf.bwd_res_plain(tables, bcfg, g, k2, resf, resi))
    err_bwd = max(err_bwd, compare_grads(k3, ref, "K3 1M lanes past 64"))
    p_plain["K4"], ref = once_ms(lambda: kwf.bwd_replay_plain(
        tables, bcfg, o, d, 7, None, None, g, k1))
    err_replay = max(err_replay, compare_grads(k4, ref,
                                               "K4 1M lanes past 64"))
    del ref
    tx = scene.textures
    leaves = [t.clone().requires_grad_() for t in (
        scene.mat_diffuse, scene.mat_specular, scene.emission, tx.color_a,
        tx.color_b, tx.image)]
    p64_replay = kwf.make_cuda_diff_tracer(scene, bcfg, backward="replay")
    reset_counts()
    reset_big()
    (p64_replay(*leaves, scene.env_radiance_, o, d, 7).sum()
     / n_big).backward()
    torch.cuda.synchronize()
    p64_replay_launches = counts()
    take_tags("the replay path past 64")
    if p64_replay_launches != (1, 0, 0, 1) or big_counts() != (0, 0, 0, 0) \
            or not all(torch.equal(t.grad.reshape(a.shape), a)
                       for t, a in zip(leaves, k4[:3] + k4[4:])):
        raise AssertionError(f"the replay path past 64 launched K1-K4 "
                             f"{p64_replay_launches} and K5-K8 {big_counts()},"
                             f" or its gradient is not K4's")
    del leaves
    p_cache = resf.numel() * 4 + resi.numel() * 4
    ops1 = k1_ops(tables.static, resf, bcfg)
    ops4 = k4_ops(tables.static, resf, bcfg)
    m_rows = len(tables.static["mats"]["kind"])
    # the culled count from the lanes' own rays (the plain K2 equals K2 to
    # the last bit here, checked above)
    pcull = wf_cull_counts(tables, bcfg, o, d, 7)
    same_bits(pcull.pop("plain"), (k2, resf, resi),
              "the plain K2 of wf_cull_counts against K2, 1M lanes past 64")
    c_ops1, c_ops4 = pcull["ops"], pcull["ops"] + (ops4 - ops1)
    # as K7's and K8's: K3 reads the cache, g and L, K4 the rays, g and L;
    # both write the (M, 9) tables (the row-tagged planes and texel entries
    # are their own scratch, not the function's bytes)
    p64_full = {
        "K1": bound_ms(n_big * (24 + 12), ops1),
        "K2": bound_ms(n_big * (24 + 12) + p_cache, ops1),
        "K4": bound_ms(n_big * (24 + 12 + 12) + m_rows * 9 * 4, ops4)}
    p64_bounds = {
        "K1": bound_ms(n_big * (24 + 12), c_ops1),
        "K2": bound_ms(n_big * (24 + 12) + p_cache, c_ops1),
        "K3": bound_ms(p_cache + n_big * 24 + m_rows * 9 * 4,
                       k3_ops(tables.static, bcfg, n_big)),
        "K4": bound_ms(n_big * (24 + 12 + 12) + m_rows * 9 * 4, c_ops4)}
    print(f"timing past 64 on K1-K4: spheres 1026 surfaces, 16x16 ground "
          f"atlas, depth 3, {n_big} pixel-centre lanes: K1 {p_k1_ms:.3f} ms, "
          f"K2 {p_k2_ms:.3f} ms, K3 {p_k3_ms:.3f} ms and K4 {p_k4_ms:.3f} ms "
          f"(row-tagged, with the sorts and sums by row and texel), culled; "
          f"with cull 'off' K1 {p_off_ms['K1']:.3f} ms, K2 "
          f"{p_off_ms['K2']:.3f} ms, K4 {p_off_ms['K4']:.3f} ms, the same "
          f"bits; plain K1 "
          f"{p_plain['K1']:.1f} ms, plain K2 {p_plain['K2']:.1f} ms, plain "
          f"K3 {p_plain['K3']:.1f} ms, plain "
          f"K4 {p_plain['K4']:.1f} ms, the kernels within the bounds of "
          f"phase 3; K4 vs K3 max |diff| {xerr:.3g}; the replay path "
          f"(make_cuda_diff_tracer(backward='replay')) launched K1/K2/K3/K4 "
          f"{p64_replay_launches}, its gradient K4's bit for bit; "
          f"pack_tables {pack_s * 1e3:.1f} ms on the host; on {smi}",
          flush=True)
    print(f"cull past 64: K1, K2 and K4 = cull='off' bit for bit at 1M "
          f"lanes; {pcull['blocks']} blocks, {pcull['supers']} superblocks; "
          f"pass rates {pass_rates(pcull)}", flush=True)
    for k, (t, by) in p64_bounds.items():
        full = (f", full sweep {p64_full[k][0]:.4f} ms by {p64_full[k][1]}"
                if k in p64_full else "")
        print(f"bound past 64: {k} {t:.4f} ms by {by} (culled K1 ops "
              f"{c_ops1:.4g}, K4 ops {c_ops4:.4g}; full sweep K1 ops "
              f"{ops1:.4g}, K4 ops {ops4:.4g}; cache {p_cache:.4g} B{full})",
              flush=True)
    del k1, k2, k3, k4, resf, resi, g, o, d

    # the textured K5, K7 and K8 at the 1M pixel-centre lanes (checker
    # ground), with the plain versions once and the replay path (K5 + K8)
    scene = p64_cuda["checker"]
    o, d = pixel_centre_rays(scene, n_big)
    tables = kbs.pack_big_tables(scene, bcfg)
    t_k5_ms, k5 = cuda_time_ms(lambda: kbs.trace_lanes(tables, bcfg, o, d, 7),
                               3)
    k6, resf, resi = kbs.trace_lanes(tables, bcfg, o, d, 7, residual=True)
    g = torch.full((n_big, 3), 1.0 / n_big, device="cuda")
    t_k7_ms, k7 = cuda_time_ms(
        lambda: kbs.bwd_res(tables, bcfg, g, k6, resf, resi), 3)
    t_k8_ms, k8 = cuda_time_ms(
        lambda: kbs.bwd_replay(tables, bcfg, o, d, 7, None, None, g, k5), 3)
    t_plain = {}
    t_plain["K5"], ref = once_ms(
        lambda: kbs.trace_lanes_plain(tables, bcfg, o, d, 7))
    _, mabs, _ = compare(k5, ref, "textured K5 1M lanes")
    err_k5 = max(err_k5, mabs)
    t_plain["K8"], ref = once_ms(lambda: kbs.sums_plain(
        tables, bcfg, *kbs.bwd_replay_plain(tables, bcfg, o, d, 7, None, None,
                                            g, k5)))
    err_k8 = max(err_k8, compare_grads(k8, ref, "textured K8 1M lanes"))
    xerr = compare_grads(k8, k7, "textured K8 vs K7 1M lanes", CROSS_RTOL,
                         CROSS_ATOL)
    del ref
    tx = scene.textures
    leaves = [t.clone().requires_grad_() for t in (
        scene.mat_diffuse, scene.mat_specular, scene.emission, tx.color_a,
        tx.color_b)]
    tex_replay = kbs.make_bigscene_diff_tracer(scene, bcfg, backward="replay")
    reset_counts()
    reset_big()
    (tex_replay(*leaves, scene.env_radiance_, o, d, 7).sum()
     / n_big).backward()
    torch.cuda.synchronize()
    tex_big_replay = big_counts()
    take_tags("the textured big-scene replay path")
    if tex_big_replay != (1, 0, 0, 1) or counts() != (0, 0, 0, 0) or \
            not all(torch.equal(t.grad, a)
                    for t, a in zip(leaves, k8[:3] + k8[4:])):
        raise AssertionError(f"the textured big replay path launched K5-K8 "
                             f"{tex_big_replay} and K1-K4 {counts()}, or its "
                             f"gradient is not K8's")
    same_as_cull_off(tables, bcfg, (o, d, 7, None, None), g,
                     (k5, (k6, resf, resi), k8), "textured spheres 1M lanes")
    ops5t = k5_ops(tables, resf, bcfg)
    ops8t = k8_ops(tables, resf, bcfg)
    twalk = {}
    t_rows, t_sweeps, t_bounds, *_ = swept_counts(tables, bcfg, o, d, 7,
                                                  stats=twalk)
    del twalk["plain"]
    t_cache = resf.numel() * 4 + resi.numel() * 4
    PB = 9
    tex_full = {"K5": bound_ms(n_big * (24 + 12), ops5t),
                "K8": bound_ms(n_big * (24 + 12 + 12) + m_rows * PB * 4,
                               ops8t)}
    ops5t, ops8t = twalk["ops"], twalk["ops"] + (ops8t - ops5t)
    tex_bounds = {
        "K5": bound_ms(n_big * (24 + 12), ops5t),
        "K7": bound_ms(t_cache + n_big * 24 + m_rows * PB * 4, float(
            n_big * (bcfg.max_depth * (45 + 27 * len(tables.static["lights"]))
                     + 6))),
        "K8": bound_ms(n_big * (24 + 12 + 12) + m_rows * PB * 4, ops8t)}
    print(f"timing textured past 64: spheres 1026 surfaces, checker ground, "
          f"depth 3, {n_big} pixel-centre lanes: K5 {t_k5_ms:.3f} ms, K7 "
          f"{t_k7_ms:.3f} ms, K8 {t_k8_ms:.3f} ms (K7 and K8 with their sorts "
          f"and sums by row); plain K5 {t_plain['K5']:.1f} ms, plain K8 "
          f"{t_plain['K8']:.1f} ms, the kernels within the bounds of phase 3;"
          f" K8 vs K7 max |diff| {xerr:.3g}; the replay path launched "
          f"K5/K6/K7/K8 {tex_big_replay}, its gradient K8's bit for bit; on "
          f"{smi}", flush=True)
    print(f"cull textured: K5, K6 and K8 = cull='off' bit for bit at 1M "
          f"lanes; the tree walk {t_rows / t_sweeps:.1f} rows and "
          f"{t_bounds / t_sweeps:.1f} node steps of the warp a lane-sweep",
          flush=True)
    for k, (t, by) in tex_bounds.items():
        full = (f", full sweep {tex_full[k][0]:.4f} ms by {tex_full[k][1]}"
                if k in tex_full else "")
        print(f"bound textured: {k} {t:.4f} ms by {by} (culled K5 ops "
              f"{ops5t:.4g}, K8 ops {ops8t:.4g}, cache {t_cache:.4g} B{full})",
              flush=True)
    del k5, k6, k7, k8, resf, resi, g, o, d, leaves

    # 11e. a smallpt frame through render() (K1)
    reset_counts()
    img = render(builders.smallpt(256, 256), spp=16, seed=seed, clamp=False)
    torch.cuda.synchronize()
    smallpt_launches = counts()
    a = img.cpu().numpy()
    if smallpt_launches[0] == 0 or not np.isfinite(a).all() or (a < 0).any() \
            or a.mean() <= 0:
        raise AssertionError(f"smallpt frame: launches {smallpt_launches}, "
                             f"mean {a.mean()}")
    spt = builders.smallpt(256, 256).to("cuda")
    cfg = kwf.KernelConfig(max_depth=5, sampler="hash")
    o, d, si, pix = jittered_rays(spt, 1 << 16, 53)
    tables = kwf.pack_tables(spt, cfg)
    k1 = kwf.trace_lanes(tables, cfg, o, d, 59, si, pix)
    k2 = kwf.trace_lanes(tables, cfg, o, d, 59, si, pix, residual=True)
    same_bits(k1, kwf.trace_lanes_plain(tables, cfg, o, d, 59, si, pix),
              "K1 smallpt")
    same_bits(k2, kwf.trace_lanes_plain(tables, cfg, o, d, 59, si, pix,
                                        residual=True), "K2 smallpt")
    print(f"frame: smallpt 256x256 16 spp through render(): mean "
          f"{a.mean():.5f}, launches K1/K2/K3/K4 {smallpt_launches}; K1 and "
          f"K2 (radiance, cache) = plain bit for bit on {o.shape[0]} lanes, "
          f"depth 5, hash (tables in shared memory: {tables.stage_bytes} B)",
          flush=True)
    del img, k1, k2

    # 12. the jnp engines and their train step (no kernel of their own)
    jnp_engines()

    # 13. past 32 lights and 64 textures, then distribution
    caps = past_the_caps(smi)
    sharded = distribution(smi)

    # 14. the entry points: the render and inverse CLIs, the grid, the
    # native encoder
    entry = entry_points(smi)

    # 15. the last entry points: bench, nanopt, the parity tools
    last = last_entry_points(smi, fb_ms)

    # 16. the sphereflake at its published size
    sphereflake(smi)

    # 17. the tetrahedral pyramid: the triangle rows past 64 surfaces
    tetra(smi)

    src = "kytpu_torch/kernels/csrc/"
    tex_steps = [sum(tl[k] for tl in tex_train.values()) for k in (1, 2)]
    rows = [("wavefront_fwd", "wavefront_fwd.cu",
             "kytpu/kernels/wavefront.py:1760",
             render_launches[0] + tex_render_launches[0]
             + sep_render_launches[0] + smallpt_launches[0]
             + p64_replay_launches[0], max_abs_err, ms, plain_ms, "K1"),
            ("wavefront_fwd_res", "wavefront_fwd.cu",
             "kytpu/kernels/wavefront.py:3349",
             train_launches[1] + gloss_launches[1] + tex_steps[0]
             + sep_train[1], err_res, k2_ms, plain_k2_ms, "K2"),
            ("wavefront_bwd_res", "wavefront_bwd_res.cu",
             "kytpu/kernels/wavefront.py:3445",
             train_launches[2] + gloss_launches[2] + tex_steps[1]
             + sep_train[2], err_bwd, k3_ms, plain_k3_ms, "K3"),
            ("wavefront_bwd_replay", "wavefront_fwd.cu",
             "kytpu/kernels/wavefront.py:3470",
             replay_launches[3] + tex_replay_launches[3]
             + p64_replay_launches[3], err_replay, k4_ms, plain_k4_ms, "K4"),
            ("bigscene_fwd", "bigscene_fwd.cu",
             "kytpu/kernels/bigscene.py:2144",
             big_render_launches[0] + tex_big_launches[0] + tex_big_replay[0],
             err_k5, k5_ms, plain_k5_ms, "K5"),
            ("bigscene_fwd_res", "bigscene_fwd.cu",
             "kytpu/kernels/bigscene.py:2361",
             big_train_launches[1] + tex_big_train[1], err_k6, k6_ms,
             plain_k6_ms, "K6"),
            ("bigscene_bwd_res", "bigscene_bwd_res.cu",
             "kytpu/kernels/bigscene.py:2421",
             big_train_launches[2] + tex_big_train[2], err_k7, k7_ms,
             plain_k7_ms, "K7"),
            ("bigscene_bwd_replay", "bigscene_fwd.cu",
             "kytpu/kernels/bigscene.py:2445",
             big_replay_launches[3] + tex_big_replay[3], err_k8, k8_ms,
             plain_k8_ms, "K8")]
    # phase 13's, 14's and 15's main paths and checks
    extra = {k: caps["launches"].get(k, 0) + sharded["launches"].get(k, 0)
             + entry["launches"].get(k, 0) + last["launches"].get(k, 0)
             for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")}
    rows = [(nm, f, rp, nl + extra[k], max(err, caps["errs"][k],
                                          entry["errs"].get(k, 0.0)), t, pt, k)
            for nm, f, rp, nl, err, t, pt, k in rows]
    main_tags[0] += caps["launches"].get("tag_sort", 0)
    main_tags[1] += caps["launches"].get("segment_sums", 0)
    # the sums by tag that finish K7 (and K8, K3 and K4 past 64 surfaces,
    # and every texel sum), timed on K7's row tags at the spheres' 1M lanes;
    # each equals its plain version to the last bit (check_tag_sums)
    if main_tags[0] == 0 or main_tags[1] == 0:
        raise AssertionError(f"the main paths launched the tag sort and the "
                             f"segment sums {main_tags} times")
    t7 = tag_k7[0]
    bounds["tag_sort"], bounds["segment_sums"] = (t7["sort_bound"],
                                                  t7["seg_bound"])
    rows += [("tag_sort", "tag_sums.cu", "kytpu/kernels/bigscene.py:2480",
              main_tags[0], 0.0, t7["sort_ms"], t7["plain_sort_ms"],
              "tag_sort"),
             ("segment_sums", "tag_sums.cu", "kytpu/kernels/bigscene.py:2480",
              main_tags[1], 0.0, t7["seg_ms"], t7["plain_seg_ms"],
              "segment_sums")]
    # one torch.sort(stable=True) of the keys gives the sort's perm; one
    # index_add_ of the entries' values by tag gives the sums
    library = {"tag_sort": t7["lib_sort_ms"],
               "segment_sums": t7["lib_seg_ms"]}
    # the camera rays, timed at the train step's 10M lanes; one PyTorch
    # call computing the same function there is none
    bounds["rays"] = rays_bound
    rows.append(("camera_rays", "camera_rays.cu",
                 "none (jax.random and XLA on the TPU)", main_rays, 0.0,
                 rays_ms["train"], rays_plain_ms["train"], "rays"))
    print(smi)
    print(json.dumps({"kernels": [
        {"name": nm, "route": "cuda", "source": src + f, "replaces": rp,
         "launches": nl, "max_abs_err": err, "ms": t, "plain_ms": pt,
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": library.get(k)}
        for nm, f, rp, nl, err, t, pt, k in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def sphereflake(smi: str) -> None:
    """Phase 16: SPD's sphereflake (builders.spd_balls(), 7,382 surfaces)
    at its published 512x512, the benchmark's spd_balls.table_train4 step
    (`table_step` with names ("mat_diffuse", "mat_specular",
    "env_radiance_"))."""
    from kytpu_torch.scene import builders

    table_step(smi, "sphereflake", builders.spd_balls,
               ("mat_diffuse", "mat_specular", "env_radiance_"))


def tetra(smi: str) -> None:
    """Phase 17: SPD's tetrahedral pyramid (builders.spd_tetra), 4,096 matte
    triangles of the tri class and a floor at its published size factor 6,
    and 256 at factor 4 (257 surfaces), at 512x512: the benchmark's
    spd_tetra.tri_train4 step (`table_step` with names ("mat_diffuse",
    "env_radiance_")), the triangle rows of K6's walk and K7's sums into
    Lambertian rows."""
    from kytpu_torch.scene import builders

    for factor in (4, 6):
        table_step(smi, f"tetra {factor}",
                   lambda f=factor: builders.spd_tetra(f),
                   ("mat_diffuse", "env_radiance_"))


def table_step(smi: str, label: str, build, names) -> None:
    """A scene past 64 surfaces (`build()` at 512x512) through
    make_train_step(engine="cuda") at its default 4 spp, depth 5, training
    `names` from the scene's diffuse x0.8 and sky x1.2 towards its own
    4-spp frame: the launches of three steps (K6 and K7 only), the step's
    own K6 and K7 calls on their first 64K lanes against the plain
    versions (the bounds of phase 3, and whether bit for bit), K6 culled
    against cull="off" bit for bit, the counters of a recorded K6 launch,
    the tri class's share included, against `swept_counts` to the count
    (printed first), and K6 and K7 (with the sort and sums) timed at the
    step's 1,048,576 lanes under CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff.inverse import make_train_step
    from kytpu_torch.integrator.render import render
    from kytpu_torch.kernels import bigscene as kbs
    from kytpu_torch.kernels import wavefront as kwf

    t_phase = time.perf_counter()
    scene = build()
    target = render(scene, spp=4, seed=7, cfg=kwf.KernelConfig(max_depth=5),
                    clamp=False, engine="cuda")
    start = build()
    start = dataclasses.replace(start, mat_diffuse=start.mat_diffuse * 0.8,
                                env_radiance_=start.env_radiance_ * 1.2)
    step, params, _ = make_train_step(start, target, spp=4, max_depth=5,
                                      engine="cuda", names=names)
    kprof.reset("k2", "k3", "k5", "k6", "k7")
    key = krng.key(2**31 + 99)
    with recording(kbs) as seen:
        losses = [float(step(krng.fold_in(key, i))) for i in range(3)]
    torch.cuda.synchronize()
    got = {k: kprof.launches(k) for k in ("k2", "k3", "k5", "k6", "k7")}
    if got["k6"] != 3 or got["k7"] != 3 or got["k2"] or got["k3"]:
        raise AssertionError(f"the {label} step launched {got}")
    step_ms, _ = wall_ms(lambda: step(krng.fold_in(key, 9)).item())
    print(f"{label}: {int(scene.mat_kind.shape[0])} surfaces, "
          f"{scene.camera.width}x{scene.camera.height}, 4 spp, depth 5: 3 "
          f"steps launched {got}, losses "
          f"{[round(x, 6) for x in losses]}, {step_ms:.2f} ms a step; on "
          f"{smi}", flush=True)
    tabs, (kcfg, o, d, seed, si, pix), kw, k6 = seen["trace_lanes"]
    btabs, (_, g, big_l, resf, resi), _, k7 = seen["bwd_res"]
    n = 1 << 16
    lanes = (o[:n], d[:n], seed, si, pix)
    # the tree walk's counts from the plain K6's rays (the walk's
    # prediction)
    t0 = time.perf_counter()
    own = {}
    walked = swept_counts(tabs, kcfg, *lanes, stats=own)
    print(f"{label}: replay of the step's first {n} lanes, a "
          f"lane-sweep ({walked[1]} lane-sweeps): tree walk (arity "
          f"{kbs.ARITY}, {kbs.LEAF_BUF} pending blocks) "
          f"{walked[0] / walked[1]:.1f} rows ({walked[3] / walked[1]:.1f} "
          f"of the tri class), {walked[2] / walked[1]:.1f} node steps "
          f"({walked[4] / walked[1]:.1f}) of the warp; a lane's own "
          f"{own['lane_rows'] / walked[1]:.1f} rows, "
          f"{own['lane_bounds'] / walked[1]:.1f} node steps; "
          f"{own['blocks'] / max(own['phases'], 1):.2f} distinct blocks a "
          f"leaf phase; {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ref = kbs.trace_lanes_plain(tabs, kcfg, *lanes, residual=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mine = kbs.trace_lanes(tabs, kcfg, *lanes, residual=True)
    share, err, _ = compare(mine[0], ref[0], f"{label} K6")
    cerr = compare_cache(mine[1], mine[2], ref[1], ref[2],
                         f"{label} K6 cache")
    k6_bits = all(torch.equal(a, b) for a, b in zip(mine, ref))
    k7_mine = kbs.bwd_res(btabs, kcfg, g[:n].contiguous(), mine[0], mine[1],
                          mine[2])
    k7_ref = kbs.bwd_res_plain(btabs, kcfg, g[:n].contiguous(), *ref)
    gerr = compare_grads(k7_mine, k7_ref, f"{label} K7")
    k7_bits = all(torch.equal(a, b) for a, b in zip(k7_mine, k7_ref))
    off = dataclasses.replace(kcfg, cull="off")
    same_bits(mine, kbs.trace_lanes(tabs, off, *lanes, residual=True),
              f"{label} K6 culled against cull='off'")
    kprof.reset("k6")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        kbs.trace_lanes(tabs, kcfg, *lanes, residual=True)
        torch.cuda.synchronize()
    counted = kprof.device_counts()
    counts = tuple(counted.get(f"kernel.k6.{k}") for k in kprof.SWEPT)
    if counts != walked:
        raise AssertionError(f"{label} K6's counters {kprof.SWEPT} read "
                             f"{counts}; the replay {walked}")
    rows, sweeps, bounds, tri_rows, tri_bounds = counts
    print(f"{label}: the step's K6 and K7 on its first {n} lanes: K6 "
          f"{share:.5f} of lanes outside the bound (max |err| {err:.3g}), "
          f"cache max |err| {cerr:.3g}, bit for bit: {k6_bits}; K7 max |err| "
          f"{gerr:.3g}, bit for bit: {k7_bits}; K6 culled = cull 'off' bit "
          f"for bit; the counters {rows} rows ({tri_rows} tri) and {bounds} "
          f"node steps ({tri_bounds} tri) over {sweeps} lane-sweeps "
          f"({rows / max(sweeps, 1):.1f} rows of {sum(tabs.counts)} and "
          f"{bounds / max(sweeps, 1):.1f} node steps a lane-sweep) = the "
          f"replay; plain K6 {plain_ms:.1f} ms", flush=True)
    full = (o, d, seed, si, pix)
    k6_ms, _ = cuda_time_ms(lambda: kbs.trace_lanes(tabs, kcfg, *full,
                                                    residual=True), 3)
    k7_ms, _ = cuda_time_ms(lambda: kbs.bwd_res(btabs, kcfg, g, big_l, resf,
                                                resi), 3)
    kprof.reset("k6")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        kbs.trace_lanes(tabs, kcfg, *full, residual=True)
        torch.cuda.synchronize()
    counted = kprof.device_counts()
    got = {k: counted[f"kernel.k6.{k}"] for k in kprof.SWEPT}
    print(f"{label}: at the step's {o.shape[0]} lanes K6 {k6_ms:.3f} ms, "
          f"K7 with its sort and sums {k7_ms:.3f} ms; "
          f"{got['rows'] / got['sweeps']:.1f} rows "
          f"({got['rows.tri'] / got['sweeps']:.1f} tri) and "
          f"{got['bounds'] / got['sweeps']:.1f} node steps "
          f"({got['bounds.tri'] / got['sweeps']:.1f} tri) a lane-sweep; "
          f"phase {time.perf_counter() - t_phase:.1f} s; on {smi}",
          flush=True)


class _LastLine:
    """Standard output that remembers the last line written to it."""

    def __init__(self, stream):
        self.stream, self.last = stream, ""

    def write(self, s: str) -> int:
        lines = [ln for ln in s.splitlines() if ln.strip()]
        if lines:
            self.last = lines[-1]
        return self.stream.write(s)

    def __getattr__(self, name):
        return getattr(self.stream, name)


if __name__ == "__main__":
    sys.stdout = out = _LastLine(sys.stdout)
    try:
        if sys.argv[1:] in (["sphereflake"], ["tetra"]):
            # phase 16 or 17 alone, after the device and the build
            from kytpu_torch.kernels import build as kbuild
            kbuild.load()
            smi_line = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
            {"sphereflake": sphereflake, "tetra": tetra}[sys.argv[1]](
                smi_line)
        else:
            main()
    except Exception:
        traceback.print_exc()
        out.flush()
        print("chip_smoke.py failed; the last line it printed: "
              f"{out.last or '(none)'}",
              file=sys.stderr, flush=True)
        sys.exit(1)
    sys.stdout.flush()
