"""Shared by the rate readers: rays of every call completed in the window
over the window's seconds."""


def rays_per_s(run, entry: str):
    if run.entry != entry or not run.calls:
        return None
    return run.lanes * len(run.calls) / run.window_s
