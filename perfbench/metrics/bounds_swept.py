"""bounds_swept.<entry>: the node steps that a step forward's tree walks
took, per lane-sweep: K6's node-step counter (`kernel.k6.bounds` over
`kernel.k6.sweeps`, csrc/bigscene_fwd.cu: each lane of a sweep, closest
hit or occlusion, counts the node steps its warp took in each class's
tree walk), read once from the card after the traced window. A program
without the counter, or a run without a traced window or a K6 launch in
it, gives None."""


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
    bounds, sweeps = got.get("kernel.k6.bounds"), got.get("kernel.k6.sweeps")
    return bounds / sweeps if sweeps and bounds is not None else None
