"""tri_rows_swept.<entry>: the triangle rows that a step forward's sweeps
tested, per lane-sweep: the tri class's share of K6's row counter
(`kernel.k6.rows.tri` over `kernel.k6.sweeps`, csrc/bigscene_fwd.cu: each
lane of a sweep counts the rows of the blocks its warp's leaf phases
tested in the tri tree), read once from the card after the traced window.
A program without the class split, or a run without a traced window or a
K6 launch in it, gives None."""


def per_sweep(run, part, counter: str):
    """`counter` of the program's device counts over `kernel.k6.sweeps`,
    or None."""
    if run.entry != part or run.profile is None:
        return None
    try:
        from kytpu_torch.utils import profiling
    except ImportError:
        return None
    counts = getattr(profiling, "device_counts", None)
    if counts is None:
        return None
    got = counts()
    n, sweeps = got.get(counter), got.get("kernel.k6.sweeps")
    return n / sweeps if sweeps and n is not None else None


def read(run, part):
    return per_sweep(run, part, "kernel.k6.rows.tri")
