"""Shared by the readers of the program's own spans
(`kytpu_torch.utils.profiling`): the records the traced window left, and
the calls of the cell's entry point among them.

The program records spans only while torch.profiler records, so the
records are those of the traced window (`devtrace.profile_calls`, a
retake included); every value is per call, over the entry spans
recorded. A program without spans (a checkout older than them) gives
None, and its readers report nothing."""

ENTRY = {"train": "kytpu::train.step", "frame": "kytpu::render.frame"}
KERNEL = "kytpu::kernel."
LAUNCH = "kytpu::launch."
TABLES = "kytpu::tables."


def window(run, part):
    """(records, indices of the entry spans) of the traced window, or None
    where the run has no traced window or the program recorded no call."""
    if run.entry != part or run.profile is None or part not in ENTRY:
        return None
    try:
        from kytpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    recs = spans()
    entries = [i for i, r in enumerate(recs) if r.name == ENTRY[part]]
    return (recs, entries) if entries else None


def ancestors(recs, i):
    p = recs[i].parent
    while p is not None:
        yield p
        p = recs[p].parent


def outermost(recs, entries, prefix: str, under=None) -> list:
    """Indices of the records named prefix* inside an entry span (and
    inside `under` where given) with no enclosing record so named."""
    calls = set(entries)
    out = []
    for i, r in enumerate(recs):
        if not r.name.startswith(prefix):
            continue
        up = list(ancestors(recs, i))
        if (calls.isdisjoint(up) and i not in calls) or any(
                recs[a].name.startswith(prefix) for a in up):
            continue
        if under is None or under in up:
            out.append(i)
    return out


def device_ms(recs, idx):
    """The device milliseconds of records idx summed, or None where one of
    them has no device interval (CUDA was not initialized: the CPU)."""
    total = 0.0
    for i in idx:
        ms = recs[i].device_ms
        if ms is None:
            return None
        total += ms
    return total
