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
"""

import numpy as np
import pytest
import torch

from neural_renderer_tpu_torch.ops import trace_cluster as tc
from neural_renderer_tpu_torch.ops import traversal
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
