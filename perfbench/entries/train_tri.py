"""Entry "train_tri": entries/train_table.py's step on a scene of matte
triangles past 64 surfaces (SPD's tetrahedral pyramid): the port's
`make_train_step(engine="cuda")` on the table kernels (K6 forward, K7
backward with the sort of its row tags and its sums by row), set up,
called and checked as train_table's, with the reference's scene from
reference/tetra.py and the least work from counts/tri.py (a triangle's row
test and the Lambertian path's shading). Its `entry` is "train".

train_table.py is loaded here a second time, as a module of its own whose
`ref` and `counts` are these two: the one that train_table's cell loads is
left as it is.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from perfbench.counts import tri
from perfbench.reference import tetra

_spec = importlib.util.spec_from_file_location(
    "perfbench.entries._train_table_tri",
    Path(__file__).with_name("train_table.py"))
_table = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_table)
_table.ref, _table.counts = tetra, tri

Workload = _table.Workload
