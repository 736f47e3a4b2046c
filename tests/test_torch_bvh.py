"""The port's BVH builder against the JAX package's, on the CPU.

`neural_renderer_tpu_torch/scene/bvh.py::build_bvh` (the native builder
`csrc/bvh_builder.cpp`, or its numpy fallback without a host compiler) must
give the nodes and the triangle order of
`neural_renderer_tpu/scene/bvh.py::build_bvh`: the clusters and leaves the
traces walk are cut from that order, so parity tests of the traces can
build their meshes in either package. The meshes are subdivided cubes,
whose equal-sized, axis-aligned triangles tie in the SAH cost at every
split, and a shuffled copy of one, where the ties meet the triangles in
another input order.
"""

import numpy as np
import pytest
import torch

from neural_renderer_tpu.scene import bvh as jbvh

from neural_renderer_tpu_torch.scene import bvh

torch.set_num_threads(1)


def _subdivided_cube(n):
    """[12 n^2, 3, 3] triangles: each face of the unit cube cut into an
    n x n grid of squares, each square into two triangles."""
    g = np.linspace(-1.0, 1.0, n + 1)
    tris = []
    for axis in range(3):
        for side in (-1.0, 1.0):
            for i in range(n):
                for j in range(n):
                    quad = [(g[i], g[j]), (g[i + 1], g[j]),
                            (g[i + 1], g[j + 1]), (g[i], g[j + 1])]
                    pts = []
                    for a, b in quad:
                        p = [0.0, 0.0, 0.0]
                        p[axis] = side
                        p[(axis + 1) % 3] = a
                        p[(axis + 2) % 3] = b
                        pts.append(p)
                    tris.append([pts[0], pts[1], pts[2]])
                    tris.append([pts[0], pts[2], pts[3]])
    return np.asarray(tris, dtype=np.float32)


@pytest.mark.parametrize("case", ["cube4", "cube9", "cube6_shuffled"])
@pytest.mark.parametrize("max_leaf_size", [1, 4])
def test_bvh_nodes_and_leaf_order_match_jax(case, max_leaf_size):
    n = int(case[4])
    tris = _subdivided_cube(n)
    if case.endswith("shuffled"):
        tris = tris[np.random.default_rng(11).permutation(len(tris))]
    tmin, tmax = tris.min(axis=1), tris.max(axis=1)
    got, perm = bvh.build_bvh(tmin, tmax, max_leaf_size)
    want, jperm = jbvh.build_bvh(tmin, tmax, max_leaf_size)
    np.testing.assert_array_equal(perm, jperm)
    for field in ("bounds_min", "bounds_max", "left", "right", "first",
                  "count", "is_leaf"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.num_nodes > len(tris) // max_leaf_size
    assert int(got.count[got.is_leaf == 1].sum()) == len(tris)
