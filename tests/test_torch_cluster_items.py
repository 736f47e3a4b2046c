"""The invariant the clustered closest-hit kernels' work items rest on, on
the CPU (no JAX: the twin is held against JAX in tests/test_torch_gt.py).

K5 and K5-MXU (csrc/trace_cluster_stream.cuh) cut each 512-ray worklist
block into items of W rays that walk the block's front-to-back worklist
and break on their own bound: the max over the item's rays of
min(best_t, exit_t). The twin walks whole blocks; with exit_t zeroed
outside one item, its bound is that item's, so a twin run is that item's
walk. Held here, bit for bit: every item's rays get the (t, id) of the
whole-block walk, and the max of a block's item counts is the block's
count, which the kernels report as the block's clusters swept. (Rays
with exit_t 0, which hold no bound, take the block's count in the
kernels' second pass; these fixtures' such rays miss the mesh's box.)
Also the kernels' schedule, `trace_cluster.work_order`.

K1 and K1-MXU (the clustered sweep, the same walk with no break) split
each cluster's 256 triangles among an item's threads, 4 slices per ray
(2 in the matrix form), and fold the slices' accumulators per ray at the
end: the strict forward pair by the multiset rule, the other rows by
min. Held here on the twin: cutting every cluster into the kernels'
slices (the others' columns
zeroed: zero triangles have det 0 and are culled), sweeping each slice
and folding the four outputs gives the whole sweep bit for bit, on rays
aimed at the shells' shared edges, where two triangles give equal t's.
"""

import numpy as np
import pytest
import torch

from neural_renderer_tpu_torch.ops import trace_cluster as tc
from neural_renderer_tpu_torch.ops import traversal
from neural_renderer_tpu_torch.ops.trace_pallas import (_mt_tile_t,
                                                        _strict_pair_update)
from neural_renderer_tpu_torch.scene.mesh import outward_sphere

# One intra-op thread: the suite runs several pytest workers side by side.
torch.set_num_threads(1)


def _rays(n, seed):
    """tests/test_torch_gt.py's rays: from a radius-3 sphere toward points
    within radius 1.3, a quarter of them starting inside."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(3, n))
    o = 3.0 * o / np.linalg.norm(o, axis=0)
    o[:, : n // 4] *= r.uniform(0.0, 0.3, n // 4)
    d = r.uniform(-1.3, 1.3, size=(3, n)) - o
    d /= np.linalg.norm(d, axis=0)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def operands():
    """The 9,216-triangle sphere; block 0 holds 512 sorted rays, block 1
    tests/test_torch_gt.py's coherent bundle that hits the near side."""
    mesh = outward_sphere(48, 96, 1.0).to_tensors("cpu")
    o, d = _rays(1024, seed=5)
    r = np.random.default_rng(6)
    o[:, 512:] = np.array([[0.0], [0.0], [3.0]], np.float32)
    target = np.concatenate([r.uniform(-0.4, 0.4, size=(2, 512)),
                             np.zeros((1, 512))])
    d[:, 512:] = target - o[:, 512:]
    d /= np.linalg.norm(d, axis=0)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    order = traversal._ray_sort_order(o[:, :512], d[:, :512])
    o[:, :512], d[:, :512] = o[:, :512][:, order], d[:, :512][:, order]
    ops = traversal.clustered_trace_operands(mesh, o, d)
    assert not bool(ops[7].any())
    return ops[:7]


# Every pair of (W, mode, mxu) values occurs once: the twin sweeps all 512
# rays of a block per item run, and the full product would take the file
# past 30 s on one thread.
@pytest.mark.parametrize("w,mode,mxu", [
    (32, traversal.ANY, False), (32, traversal.FORWARD_ONLY, True),
    (128, traversal.FORWARD_ONLY, False), (128, traversal.ANY, True)])
def test_items_equal_the_block_walk(operands, w, mode, mxu):
    args, exit_t = operands[:6], operands[6]
    counts = operands[5]
    nb = counts.shape[0]
    swept = torch.zeros_like(counts)
    t, tri = tc.trace_clusters_twin(*args, exit_t, mode, True, swept,
                                    mxu=mxu)
    items = torch.zeros((nb, tc.BLOCK_RAYS // w), dtype=torch.int32)
    for item in range(tc.BLOCK_RAYS // w):
        mine = torch.zeros(tc.BLOCK_RAYS, dtype=torch.bool)
        mine[item * w:(item + 1) * w] = True
        mine = mine.repeat(nb)
        item_swept = torch.zeros_like(counts)
        ti, trii = tc.trace_clusters_twin(
            *args, torch.where(mine, exit_t, 0.0), mode, True, item_swept,
            mxu=mxu)
        assert torch.equal(ti[mine], t[mine]), item
        assert torch.equal(trii[mine], tri[mine]), item
        items[:, item] = item_swept
    assert torch.equal(items.amax(dim=1), swept)
    assert (t < 1e30).sum() > 300
    # The bundle's block breaks. The sorted block's rays span the sphere,
    # so the block sweeps its whole list; 32-ray items break on their own
    # (the pairs the kernels save on incoherent rays).
    assert int(swept[1]) < int(counts[1])
    saved = int(swept[0]) * tc.BLOCK_RAYS - int(items[0].sum()) * w
    assert saved > 0 if w == 32 else saved >= 0


def test_work_order_is_stable_descending_empty_last():
    counts = torch.tensor([3, 0, 7, 3, 0, 7, 1, 1024], dtype=torch.int32)
    order = tc.work_order(counts)
    assert order.dtype == torch.int32
    assert order.tolist() == [7, 2, 5, 0, 3, 6, 1, 4]
    r = np.random.default_rng(0)
    c = r.integers(0, 5, size=300).astype(np.int32)
    want = np.lexsort((np.arange(c.size), -c))
    assert tc.work_order(torch.as_tensor(c)).tolist() == want.tolist()


def _edge_rays(mesh, n, seed):
    """n rays from a radius-3 sphere at midpoints of `mesh`'s triangle
    edges (v0-v1, v0-v2 or v1-v2, each shared with a neighbour)."""
    tp = mesh.tris_packed[:, :mesh.num_triangles].numpy()
    r = np.random.default_rng(seed)
    idx = r.integers(0, tp.shape[1], n)
    v0, e1, e2 = tp[0:3, idx], tp[3:6, idx], tp[6:9, idx]
    half = np.float32(0.5)
    edge = r.integers(0, 3, n)
    p = np.where(edge == 0, v0 + half * e1,
                 np.where(edge == 1, v0 + half * e2,
                          v0 + half * e1 + half * e2)).astype(np.float32)
    o = r.normal(size=(3, n))
    o = (3.0 * o / np.linalg.norm(o, axis=0)).astype(np.float32)
    d = (p - o).astype(np.float64)
    d /= np.linalg.norm(d, axis=0)
    return o, d.astype(np.float32)


@pytest.fixture(scope="module")
def sweep_operands():
    """`chip_smoke.py`'s shells (2,304 triangles each, 18 clusters); blocks
    0-1 aim at the outer shell's edges, block 2 at the inner's, block 3
    takes tests/test_torch_gt.py's rays."""
    outer = outward_sphere(24, 48, 1.15).to_tensors("cpu")
    inner = outward_sphere(24, 48, 0.85).to_tensors("cpu")
    parts = [_edge_rays(outer, 1024, 7), _edge_rays(inner, 512, 8),
             _rays(512, 9)]
    o = torch.as_tensor(np.concatenate([p[0] for p in parts], axis=1))
    d = torch.as_tensor(np.concatenate([p[1] for p in parts], axis=1))
    # Equal t's occur: rays whose closest forward hit two triangles share.
    t, det = _mt_tile_t(o[:, :1024], d[:, :1024], outer.tris_packed)
    t = torch.where(det > 0, t, torch.full_like(t, 1e30))
    first = t.min(dim=1, keepdim=True).values
    assert int(((t == first) & (first < 1e30)).sum(dim=1).ge(2).sum()) > 5
    return traversal.clustered_sweep_operands(outer, inner, o, d)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("with_fwd2", [True, False])
def test_sweep_slices_fold_to_the_whole_sweep(sweep_operands, with_fwd2,
                                              mxu):
    """The kernels' slices of a cluster: K1's thread s takes triangles
    [64 s, 64 s + 64); K1-MXU's warp s the n-tiles 8 s .. 8 s + 7 of each
    128-triangle feature chunk."""
    o, d, tp, ids, counts, co = sweep_operands
    whole = tc.sweep_clusters_twin(o, d, tp, ids, counts, co, with_fwd2,
                                   mxu=mxu)
    col = torch.arange(tp.shape[1]) % tc.CLUSTER_SIZE
    slice_of = (col % 128) // 64 if mxu else col // 64
    folded = None
    for s in range(2 if mxu else 4):
        part = tc.sweep_clusters_twin(o, d, tp * (slice_of == s), ids,
                                      counts, co, with_fwd2, mxu=mxu)
        if folded is None:
            folded = part
            continue
        if with_fwd2:
            m1, m2 = _strict_pair_update(folded[0], folded[4], part[0])
            folded[0], folded[4] = _strict_pair_update(m1, m2, part[4])
        else:
            folded[0] = torch.minimum(folded[0], part[0])
        folded[1:4] = torch.minimum(folded[1:4], part[1:4])
    assert torch.equal(folded, whole)
    assert int((whole[0] < 1e30).sum()) > 1500
    assert int((whole[2] < 1e30).sum()) > 400
