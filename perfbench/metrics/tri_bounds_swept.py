"""tri_bounds_swept.<entry>: the node steps that a step forward's walks
took in the tri tree, per lane-sweep: the tri class's share of K6's
node-step counter (`kernel.k6.bounds.tri` over `kernel.k6.sweeps`,
csrc/bigscene_fwd.cu: each lane of a sweep counts the node steps its warp
took in the tri tree's walk), read once from the card after the traced
window. A program without the class split, or a run without a traced
window or a K6 launch in it, gives None."""

from perfbench.metrics.tri_rows_swept import per_sweep


def read(run, part):
    return per_sweep(run, part, "kernel.k6.bounds.tri")
