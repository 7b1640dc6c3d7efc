"""frame_rays_per_s: the W x H x spp rays of every frame completed in the
window (a frame ends when its (H, W, 3) image is on the host), over the
window's seconds."""

from perfbench.metrics._rate import rays_per_s


def read(run, part=None):
    return rays_per_s(run, "frame")
