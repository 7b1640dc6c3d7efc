"""Shared by the benchmark's CPU tests: cells cut to a size a CPU holds,
and torch on one thread a worker, as the repository's tests run it.

BENCH is BENCHMARK.json with the Cornell box's cells added: their
configuration, mixes and limits are in perfbench/ and were measured (see
PERF.md), but their runs spread too widely on the card's host to hold a
bound, so BENCHMARK.json leaves them out; the tests keep them working."""

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH["configs"].append({"name": "cornell_box",
                         "file": "perfbench/configs/cornell_box.json"})
BENCH["workloads"] += [
    {"name": "cornell_box.train4", "config": "cornell_box",
     "traffic": "train4", "chips": 1},
    {"name": "cornell_box.frame64", "config": "cornell_box",
     "traffic": "frame64", "chips": 1}]
CELLS = tuple(w["name"] for w in BENCH["workloads"])
# depth 3, so a bounce is past the first and Russian roulette's
SMALL = {"args": {"width": 32, "height": 20},
         "traffic": {"spp": 2, "max_depth": 3, "target_spp": 1,
                     "check_calls": 1, "trace_seconds": 0.1}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
