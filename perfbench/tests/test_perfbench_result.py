"""The run's last line, its exits without a card, and a run on the card
(marked cuda: it skips without one)."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import BENCH, CELLS, ROOT, SMALL


@pytest.mark.parametrize("cell", CELLS)
def test_last_line_shape(cell):
    res, compared, _ = harness.run_cell(ROOT, cell, 2**31 + 5, 0.05, False,
                                        time.perf_counter(), device="cpu",
                                        sizes=SMALL, bench=BENCH)
    line = json.loads(harness.result_line(res, compared))
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in harness.metrics_of(
        BENCH, harness.cell_of(BENCH, cell), "end_to_end")}
    # no card: the memory peak is not measured and so not reported
    assert set(line["metrics"]) == set(want) - {"peak_mem_gib"}
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and m["value"] > 0
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_every_metric_has_a_reader():
    bench = harness.spec(ROOT)
    for m in bench["end_to_end"] + bench["per_layer"]:
        read, _ = harness.reader(m["name"])
        assert callable(read)


def test_no_card_no_result(tmp_path):
    """Without the card the cell asks for: an exit code other than 0 and
    no result line; so too in a directory that holds only BENCHMARK.json
    and the benchmark's files."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "cornell_box.train4", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True)
        assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "cornell_box.train4", "--seed", str(2**31 + 77), "--seconds", "2",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
