"""One-command pixel-parity gate: the port against the COMPILED reference
renderer.

Builds the reference's ky.cpp (tools/reference_build/build_reference.sh),
renders the reference's production config (cornell both_small_spheres |
light_environment, 1024^2, depth 5, iterative PT, both_mis -- ky.cpp:4675)
with BOTH renderers at equal spp, renders the port twice at different
seeds for a pure-Monte-Carlo noise floor, and FAILS if the cross-renderer
difference exceeds ``--tolerance`` times that floor (default 1.5).

The port renders through its jnp engine (`render(..., engine="jnp")`),
the path integrator that takes `PathConfig`'s variant and strategy; the
port's default engine, the kernel K1, runs another estimator.

    python -m kytpu_torch.tools.parity_ci            # full gate, 64 spp
    python -m kytpu_torch.tools.parity_ci --spp 16   # quicker, noisier floor
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_SCRIPT = os.path.join(REPO, "tools", "reference_build",
                            "build_reference.sh")
REF_BIN = "/tmp/ky_ref"     # where build_reference.sh writes the binary


def reference_source() -> str:
    """The ky.cpp that build_reference.sh compiles (its `cp` source)."""
    with open(BUILD_SCRIPT) as f:
        for line in f:
            if line.startswith("cp ") and "ky.cpp" in line:
                return line.split()[1]
    raise RuntimeError(f"{BUILD_SCRIPT} names no ky.cpp to copy")


def build_reference() -> None:
    if os.path.exists(REF_BIN):
        return
    subprocess.run(["sh", BUILD_SCRIPT], check=True)


def render_reference(spp: int) -> str:
    # argv[1] is 4*spp (smallpt convention, ky.cpp:4690)
    out_dir = os.path.dirname(REF_BIN)
    subprocess.run([REF_BIN, str(4 * spp)], cwd=out_dir, check=True,
                   env={**os.environ, "OMP_NUM_THREADS":
                        str(os.cpu_count() or 8)})
    return os.path.join(out_dir, "single.bmp")


def parity_scene(width: int = 1024, height: int = 1024):
    """The reference's production scene: the Cornell box with both small
    spheres and the environment light."""
    from kytpu_torch.scene import builders

    flags = builders.BOTH_SMALL_SPHERES | {builders.LIGHT_ENVIRONMENT}
    return builders.cornell_box(flags, width=width, height=height)


def render_image(spp: int, seed: int, width: int = 1024,
                 height: int = 1024, device="cuda"):
    """The port's frame of `parity_scene` ((H, W, 3), clamped) through the
    jnp path integrator, depth 5, iterative, both_mis."""
    from kytpu_torch.integrator import path as kpath
    from kytpu_torch.integrator.render import render

    cfg = kpath.PathConfig(max_depth=5, variant="iteration",
                           strategy="both_mis")
    return render(parity_scene(width, height), spp=spp, seed=seed, cfg=cfg,
                  engine="jnp", device=device)


def render_kytpu(spp: int, seed: int, path: str, width: int = 1024,
                 height: int = 1024, device="cuda") -> str:
    """`render_image` written to `path` as a BMP."""
    from kytpu_torch.film import io as fio

    img = render_image(spp, seed, width, height, device)
    fio.write_bmp(path, img.cpu().numpy())
    return path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--tolerance", type=float, default=1.5,
                    help="max cross-renderer diff as a multiple of the "
                         "seed-to-seed noise floor")
    ap.add_argument("--down", type=int, default=8,
                    help="downsample factor for noise cancellation")
    args = ap.parse_args()
    return main_with_args(args.spp, args.tolerance, args.down)


def main_with_args(spp: int = 64, tolerance: float = 1.5, down: int = 8,
                   device="cuda") -> int:
    """Programmatic entry (tests/test_torch_parity_tools.py runs it under
    -m parity)."""
    from kytpu_torch.tools.compare_reference import main as compare

    build_reference()
    ref_bmp = render_reference(spp)

    tmp = tempfile.mkdtemp(prefix="kytpu_parity_")
    ours_a = render_kytpu(spp, seed=1234,
                          path=os.path.join(tmp, "parity_a.bmp"),
                          device=device)
    ours_b = render_kytpu(spp, seed=977,
                          path=os.path.join(tmp, "parity_b.bmp"),
                          device=device)

    print("cross (reference vs the port):")
    cross = compare(ref_bmp, ours_a, down)
    print("noise floor (the port, seed 1234 vs 977):")
    floor = compare(ours_a, ours_b, down)

    limit = tolerance * max(floor, 1e-4)
    ok = cross <= limit
    print(f"parity: cross {cross:.4f} vs limit {limit:.4f} "
          f"({tolerance}x floor {floor:.4f}) -> {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
