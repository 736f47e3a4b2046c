"""Process start to the first timed call, in s: imports, scene load (OBJ
parse, BVH and cluster builds), weights, kernel builds and the warm-up
calls."""


def read(run):
    return run.setup_s
