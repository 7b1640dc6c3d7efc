"""`correct` against the control and the faults (faults.py), each planted
under a whole run of every cell at a size the CPU holds: the sound run
reads correct, each plant reads not correct."""

import time

import pytest

from perfbench import faults, harness
from perfbench.tests.conftest import BENCH, CELLS, ROOT, SMALL


def _run(cell):
    res, compared, _ = harness.run_cell(ROOT, cell, 2**33 + 17, 0.05, False,
                                        time.perf_counter(), device="cpu",
                                        sizes=SMALL, bench=BENCH)
    return res["correct"], compared


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    correct, compared = _run(cell)
    assert correct, compared


@pytest.mark.parametrize("plant", faults.PLANTS)
@pytest.mark.parametrize("cell", CELLS)
def test_plant_is_caught(cell, plant):
    with faults.planted(plant):
        correct, compared = _run(cell)
    assert not correct, compared
