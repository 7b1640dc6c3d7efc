"""The plain reference of the cells on SPD's tetrahedral pyramid
(frozen/scene/tetra.py): reference/tables.py's frames, train steps and
perturbed tables, unchanged, on the scene that frozen/scene/tetra.py
builds. As tables.py, it imports nothing of the port and takes nothing the
port made.
"""

from __future__ import annotations

from perfbench.reference.frozen.scene import tetra
from perfbench.reference.tables import (bs, perturbed,  # noqa: F401
                                        render_frame, train_steps)


def build_scene(config: dict, device):
    """The configuration's scene at its stated size."""
    if config["scene"] != "spd_tetra":
        raise ValueError(f"reference/tetra.py builds spd_tetra, not "
                         f"{config['scene']!r}")
    return tetra.spd_tetra(**config["args"]).to(device)
