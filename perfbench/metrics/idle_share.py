"""idle_share.<entry>: 1 - device busy / wall over the traced window, in %;
busy is the union of the device kernels' intervals."""


def read(run, part):
    if run.entry != part or run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)
