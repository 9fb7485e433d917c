"""Process start to the first measured request: imports, the kernels'
build where the checkout has none, the weights, the edge thresholds,
the server and its warm-up."""


def read(run):
    return run.setup_s
