"""The control and the faults that `correct` has to catch past 64
surfaces, planted in the port's table kernels (kernels/bigscene.py) for the
length of a `with planted(name):` block, as faults.py plants them in
K1-K4; and, run as a script, the readings the limits of a table cell were
set from (readings.py's, with these plants).

    python3 perfbench/faults_table.py --workload spd_balls.table_train4 \
        --seeds 1,2,3 [--plant control] [--out FILE]

- "control": float32 one step lower: every lane's radiance of K5 and K6
  and every table gradient of K7 rounded to bfloat16;
- "half": half of the batch left out (a step's second half of samples a
  copy of its first);
- "unchanged": Adam's step does nothing;
- "altered": K7's diffuse gradient times 1.5.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from perfbench import harness  # noqa: E402

PLANTS = ("control", "half", "unchanged", "altered")


@contextlib.contextmanager
def planted(name: str):
    from kytpu_torch.kernels import bigscene as kbs

    if name not in PLANTS:
        raise ValueError(f"unknown plant {name!r}: one of {PLANTS}")
    saved = {k: getattr(kbs, k) for k in ("make_bigscene_diff_tracer",
                                          "bwd_res", "trace_lanes")}
    adam_step = torch.optim.Adam.step
    diff, bwd, trace = (saved["make_bigscene_diff_tracer"], saved["bwd_res"],
                        saved["trace_lanes"])

    if name == "control":
        def low(x):
            return x.to(torch.bfloat16).to(torch.float32)

        def trace_b(*a, **kw):
            out = trace(*a, **kw)
            return ((low(out[0]),) + tuple(out[1:]) if isinstance(out, tuple)
                    else low(out))

        def bwd_b(*a, **kw):
            return tuple(low(g) for g in bwd(*a, **kw))

        kbs.trace_lanes, kbs.bwd_res = trace_b, bwd_b
    elif name == "half":
        def make_diff(*a, **kw):
            fn = diff(*a, **kw)

            def halved(*args):
                out = fn(*args)
                n = out.shape[0] // 2
                return torch.cat([out[:n], out[:n]])

            halved.tabs = fn.tabs
            return halved

        kbs.make_bigscene_diff_tracer = make_diff
    elif name == "unchanged":
        torch.optim.Adam.step = lambda self, closure=None: None
    else:
        def bwd_a(*a, **kw):
            out = list(bwd(*a, **kw))
            out[0] = out[0] * 1.5
            return tuple(out)

        kbs.bwd_res = bwd_a
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(kbs, k, v)
        torch.optim.Adam.step = adam_step


def read_seed(root: Path, workload: str, seed: int, plant: str | None,
              device="cuda", sizes=None, bench=None) -> dict:
    """One seed set up as a run sets it up, then checked against the
    reference (readings.read_seed with these plants)."""
    _, config, traffic, limits, entry = harness.load_cell(
        root, workload, bench, sizes)
    t0 = time.perf_counter()
    with planted(plant) if plant else contextlib.nullcontext():
        job = entry.Workload(config, traffic, seed, device)
    job.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, failed, _ = job.check(limits)
    return {"workload": workload, "seed": seed, "plant": plant,
            "numbers": numbers, "failed": failed,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--plant", choices=PLANTS)
    p.add_argument("--out")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        line = json.dumps(read_seed(Path.cwd(), args.workload, int(s),
                                    args.plant))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
