"""Process start to the window's first step: imports, the data, the
weights, the kernels' load (their build on a cold cache) and the warm-up
steps."""


def read(run):
    return run["setup_s"]
