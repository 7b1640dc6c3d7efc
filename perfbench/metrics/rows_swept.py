"""rows_swept.<entry>: the table rows that a step forward's sweeps tested,
per lane-sweep: K6's row counter (`kernel.k6.rows` over
`kernel.k6.sweeps`, csrc/bigscene_fwd.cu: each lane of a sweep, closest
hit or occlusion, counts the rows of every block its warp entered), read
once from the card after the traced window. A program without the
counter, or a run without a traced window or a K6 launch in it, gives
None."""


def read(run, part):
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
    rows, sweeps = got.get("kernel.k6.rows"), got.get("kernel.k6.sweeps")
    return rows / sweeps if sweeps else None
