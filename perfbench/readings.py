"""Readings of the numbers `correct` compares, over many seeds in one
process, with the port as it is or with a plant of faults.py: what the
limits in limits/<cell>.json were set from.

    python3 perfbench/readings.py --workload veach_mis.train64 \
        --seeds 1,2,3 [--plant control] [--out FILE]

Each seed sets the cell up as a run does (a train cell's three
checked steps; a frame cell's warm frames, then as many frames as a run
checks), and checks it against the reference. One JSON line a seed, to
standard output and appended to --out. Needs the card, as a run does.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from perfbench import faults, harness  # noqa: E402


def read_seed(root: Path, workload: str, seed: int, plant: str | None,
              device="cuda", sizes=None, bench=None) -> dict:
    _, config, traffic, limits, entry = harness.load_cell(
        root, workload, bench, sizes)
    t0 = time.perf_counter()
    with faults.planted(plant) if plant else contextlib.nullcontext():
        job = entry.Workload(config, traffic, seed, device)
        for _ in range(traffic.get("check_calls", 0) + 1
                       if job.entry == "frame" else 0):
            job.result(job.call())
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
    p.add_argument("--plant", choices=faults.PLANTS)
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
