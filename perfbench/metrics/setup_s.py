"""setup_s: process start to the first timed call: imports, the kernels'
build where the checkout has none, the scene, the inputs and the warm-up."""


def read(run, part=None):
    return run.setup_s
