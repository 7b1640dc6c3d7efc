"""train_rays_per_s: the W x H x spp rays of every step completed in the
window (a step ends when its loss is on the host), over the window's
seconds."""

from perfbench.metrics._rate import rays_per_s


def read(run, part=None):
    return rays_per_s(run, "train")
