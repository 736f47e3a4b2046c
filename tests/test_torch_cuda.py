"""The port's CUDA kernels against their PyTorch twins, on a GPU.

Imports no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit. The repository's conftest.py imports JAX, so run it with:

    python -m pytest --noconftest tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one. Tolerances: the four
trace and sweep kernels are built with -fmad=false and evaluate the twin's
expressions in the twin's order, so they are held bit-exact; the network
kernel sums its bf16 products on the tensor cores in another order than the
twin's f32 matmul (a hidden activation can move by one bf16 step), so it is
held to max|d| / max|twin| < 2e-2, as is the fused MLP kernel of
tcnn-layout networks; the training backward kernel takes the same
tensor-core sums and adds its f32 sums by atomics in no fixed order, so
each gradient is held to 1e-3 of the twin's largest |grad|; whole frames to
tests/test_frame_interpret.py's tolerance. The matrix-formulation kernels
(NR_TRACE_MXU=1) take their FP64 products on the tensor cores, exact
products whose sums round once to f32 as the twins' float64 matmuls do:
the dense ones (K8, K4-MXU) are held bit-exact to their twins, the others
to the JAX package's own kernel-against-twin bounds (hit flips under
2e-3, t within 1e-6 relative and absolute where both hit, ids equal on
99.9%; their work-item tests hold them bit-exact too), and all to its
MXU-against-oracle bounds against the default kernels (t within 1e-5
relative and, for the dense trace in all three modes, 1e-5 absolute with
ids equal on 99.9%; for the sweeps and the clustered trace 1e-6 absolute
with ids equal on 99%). The trace-kernel ablation's kernels
(ops/trace_ablation.py) round op by op like their twins and are held
bit-exact, but for `recipx`, whose approximate reciprocal (about 1 ulp,
PTX ISA) the twin takes exactly: t within 1e-6 relative, hit flips under
2e-3, ids on 99.9%; and the bf16 matrix form, whose tensor-core f32 sums
of the exact bf16 products differ from the twin's float64 sum rounded
once: the kernel-against-twin bounds above.
"""

import numpy as np
import pytest
import torch

from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.ops import (fused_network, lane_grid_kernel,
                                           lane_grid_train_kernel,
                                           trace_ablation, trace_cluster,
                                           trace_mxu, trace_pallas,
                                           traversal)
from neural_renderer_tpu_torch.render import neural_frame
from neural_renderer_tpu_torch.render.neural_march import NeuralContext
from neural_renderer_tpu_torch.render.params import RenderParams
from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
from neural_renderer_tpu_torch.scene.materials import Material
from neural_renderer_tpu_torch.scene.mesh import outward_sphere
from neural_renderer_tpu_torch.scene.scene import Scene
from neural_renderer_tpu_torch.train import (TrainConfig, init_train_state,
                                             make_train_step,
                                             sample_segment_batch,
                                             segment_domain, shell_losses)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _shells(device):
    return (outward_sphere(24, 48, 1.2).to_tensors(device),
            outward_sphere(24, 48, 0.8).to_tensors(device))


def _rays(device, n=4096, seed=7):
    r = np.random.default_rng(seed)
    o = r.normal(size=(3, n))
    o = 3.0 * o / np.linalg.norm(o, axis=0)
    o[:, : n // 4] *= r.uniform(0.0, 0.45, n // 4)
    d = r.uniform(-1.3, 1.3, size=(3, n)) - o
    d /= np.linalg.norm(d, axis=0)
    return (torch.as_tensor(o.astype(np.float32), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


@pytest.mark.parametrize("with_fwd2", [True, False])
def test_sweep_kernel_bit_exact(cuda, with_fwd2):
    outer, inner = _shells(cuda)
    ops = traversal.clustered_sweep_operands(outer, inner, *_rays(cuda))
    before = trace_cluster.sweep_clusters_stream.launches
    ker = trace_cluster.sweep_clusters_stream(*ops, with_fwd2=with_fwd2)
    assert trace_cluster.sweep_clusters_stream.launches == before + 1
    twin = trace_cluster.sweep_clusters_twin(*ops, with_fwd2=with_fwd2)
    assert ker.shape[0] == (5 if with_fwd2 else 4)
    assert torch.equal(ker, twin)


def _edge_rays(mesh, n, seed):
    """n rays from a radius-3 sphere at midpoints of `mesh`'s triangle
    edges, where two triangles give equal t's
    (tests/test_torch_cluster_items.py)."""
    tp = mesh.tris_packed[:, :mesh.num_triangles].cpu().numpy()
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
    return np.concatenate([o, d.astype(np.float32)])


def _k1_work_case(device, case):
    """K1's operands for one worklist shape: `skewed` (block 0 lists every
    cluster, the others one each), `empty` (every third block lists
    none), `single` (one 512-ray block), `edges` (rays at the shells'
    shared edges) and `two_lobes` (the second forward crossing's case)."""
    outer, inner = _shells(device)
    if case == "single":
        return traversal.clustered_sweep_operands(outer, inner,
                                                  *_rays(device, n=512))
    if case == "edges":
        od = np.concatenate([_edge_rays(outer, 2048, 3),
                             _edge_rays(inner, 1024, 4)], axis=1)
        od = torch.as_tensor(od, device=device)
        return traversal.clustered_sweep_operands(outer, inner, od[:3],
                                                  od[3:])
    if case == "two_lobes":
        r = np.random.default_rng(23)
        o = np.stack([np.full(4096, -3.0), *r.uniform(-0.3, 0.3, (2, 4096))])
        d = np.stack([np.ones(4096), *r.uniform(-0.05, 0.05, (2, 4096))])
        d /= np.linalg.norm(d, axis=0)
        return traversal.clustered_sweep_operands(
            _two_lobes(device, 24), outward_sphere(4, 8, 0.3).to_tensors(
                device),
            torch.as_tensor(o.astype(np.float32), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))
    o, d, tp, ids, counts, co = traversal.clustered_sweep_operands(
        outer, inner, *_rays(device, n=16 * 512, seed=29))
    nb = counts.shape[0]
    if case == "skewed":
        clusters = tp.shape[1] // trace_cluster.CLUSTER_SIZE
        rows = ids.view(nb, -1)
        rows[0, :clusters] = torch.arange(clusters, device=device)
        rows[1:, 0] = torch.arange(1, nb, device=device) % clusters
        counts = torch.ones_like(counts)
        counts[0] = clusters
    else:
        counts = counts.clone()
        counts[::3] = 0
    return o, d, tp, ids, counts, co


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("with_fwd2", [True, False])
@pytest.mark.parametrize("case", ["skewed", "empty", "single", "edges",
                                  "two_lobes"])
def test_sweep_items_bit_exact(cuda, case, with_fwd2, mxu):
    """K1 and K1-MXU (work items on the clustered walk, longest worklist
    first) bit-exact to their twins on every row; blocks with count 0
    write the miss."""
    ops = _k1_work_case(cuda, case)
    wrapper = (trace_cluster.sweep_clusters_stream_mxu if mxu
               else trace_cluster.sweep_clusters_stream)
    before = wrapper.launches
    ker = wrapper(*ops, with_fwd2=with_fwd2)
    assert wrapper.launches == before + 1
    twin = trace_cluster.sweep_clusters_twin(*ops, with_fwd2, mxu=mxu)
    torch.cuda.synchronize()
    assert ker.shape == (5 if with_fwd2 else 4, ops[0].shape[1])
    assert torch.equal(ker, twin)
    assert (ker[0] < 1e30).sum() > 200
    empty = (ops[4] == 0).repeat_interleave(512)
    assert (ker[:, empty] == 1e30).all()
    if case == "two_lobes" and with_fwd2:
        assert (ker[4] < 1e30).sum() > 3000


@pytest.mark.parametrize("mode", [traversal.ANY, traversal.FORWARD_ONLY,
                                  traversal.BACKWARD_ONLY])
def test_dense_kernel_bit_exact(cuda, mode):
    outer, _ = _shells(cuda)
    o, d = _rays(cuda, n=4000)
    active = torch.rand(4000, generator=torch.Generator().manual_seed(1)) \
        .to(cuda) < 0.9
    o3, d3, tp, bm = traversal.dense_trace_operands(outer, o, d, active)
    ker = trace_pallas.trace_dense(o3, d3, tp, mode, bm)
    twin = trace_pallas.trace_dense_twin(o3, d3, tp, mode, bm)
    assert torch.equal(ker[0], twin[0])
    assert torch.equal(ker[1].view(torch.int32), twin[1].view(torch.int32))


@pytest.mark.parametrize("early_out", [True, False])
@pytest.mark.parametrize("mode", [traversal.ANY, traversal.FORWARD_ONLY,
                                  traversal.BACKWARD_ONLY])
def test_clustered_trace_kernel_bit_exact(cuda, mode, early_out):
    """K5 on a 9,216-triangle sphere: t, triangle ids and the clusters each
    block swept equal the twin's; sorted rays so the break fires."""
    mesh = outward_sphere(48, 96, 1.0).to_tensors(cuda)
    o, d = _rays(cuda, n=4000, seed=11)
    active = torch.rand(4000, generator=torch.Generator().manual_seed(2)) \
        .to(cuda) < 0.9
    order = traversal._ray_sort_order(o, d, active)
    ops = traversal.clustered_trace_operands(mesh, o[:, order], d[:, order],
                                             active[order])
    args = ops[:7]
    swept_k = torch.zeros_like(ops[5])
    swept_t = torch.zeros_like(ops[5])
    before = trace_cluster.trace_clusters_stream.launches
    kt, ktri = trace_cluster.trace_clusters_stream(*args, mode, early_out,
                                                   swept_k)
    assert trace_cluster.trace_clusters_stream.launches == before + 1
    tt, ttri = trace_cluster.trace_clusters_twin(*args, mode, early_out,
                                                 swept_t)
    assert torch.equal(kt, tt) and torch.equal(ktri, ttri)
    assert torch.equal(swept_k, swept_t)
    assert (kt < 1e30).sum() > 500
    if not early_out:
        assert torch.equal(swept_k, ops[5])
    brute = traversal.trace_mesh_brute(mesh, o[:, order][:, :512],
                                       d[:, order][:, :512], mode)
    live = active[order][:512]
    assert torch.equal(kt[:512][live], brute.t[live])


def _k5_work_case(device, case):
    """K5 / K5-MXU operands on the 9,216-triangle sphere that stress the
    work items and their schedule: `skewed`, one 512-ray block of
    incoherent rays with a long worklist among 15 blocks of inactive rays
    (count 0); `ragged`, 2,900 sorted rays (6 blocks, a padded tail: no
    whole wave of items); `bounce`, first-bounce-like rays, sorted: from
    points just outside the surface in uniform random directions, half
    into the sphere. In the last two a tenth of the rays are inactive
    (exit_t 0): passengers, which the block rule sweeps to its count."""
    mesh = outward_sphere(48, 96, 1.0).to_tensors(device)
    if case == "skewed":
        o, d = _rays(device, n=16 * 512, seed=13)
        active = torch.zeros(16 * 512, dtype=torch.bool, device=device)
        active[5 * 512:6 * 512] = True
        ops = traversal.clustered_trace_operands(mesh, o, d, active)
        assert int((ops[5] > 0).sum()) == 1 and int(ops[5][5]) > 20
        return ops
    if case == "ragged":
        o, d = _rays(device, n=2900, seed=17)
    else:
        r = np.random.default_rng(19)
        p = r.normal(size=(3, 4096))
        p /= np.linalg.norm(p, axis=0)
        q = r.normal(size=(3, 4096))
        q /= np.linalg.norm(q, axis=0)
        o = torch.as_tensor((1.001 * p).astype(np.float32), device=device)
        d = torch.as_tensor(q.astype(np.float32), device=device)
    active = torch.as_tensor(np.random.default_rng(23).uniform(
        size=o.shape[1]) < 0.9, device=device)
    order = traversal._ray_sort_order(o, d, active)
    return traversal.clustered_trace_operands(mesh, o[:, order], d[:, order],
                                              active[order])


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("early_out", [True, False])
@pytest.mark.parametrize("mode", [traversal.ANY, traversal.FORWARD_ONLY,
                                  traversal.BACKWARD_ONLY])
@pytest.mark.parametrize("case", ["skewed", "ragged", "bounce"])
def test_clustered_trace_items_bit_exact(cuda, case, mode, early_out, mxu):
    """K5 and K5-MXU (work items that break on their own, longest worklist
    first) bit-exact to their twins in t, ids and clusters swept per block;
    the items' counts reduce by max to the block's."""
    ops = _k5_work_case(cuda, case)
    args = ops[:7]
    wrapper = (trace_cluster.trace_clusters_stream_mxu if mxu
               else trace_cluster.trace_clusters_stream)
    swept_k = torch.zeros_like(ops[5])
    swept_t = torch.zeros_like(ops[5])
    before = wrapper.launches
    kt, ktri = wrapper(*args, mode, early_out, swept_k)
    assert wrapper.launches == before + 1
    tt, ttri = trace_cluster.trace_clusters_twin(*args, mode, early_out,
                                                 swept_t, mxu=mxu)
    torch.cuda.synchronize()
    assert torch.equal(kt, tt) and torch.equal(ktri, ttri)
    assert torch.equal(swept_k, swept_t)
    assert (kt < 1e30).sum() > 100
    if not early_out:
        assert torch.equal(swept_k, ops[5])
    if case == "skewed":
        assert (kt.view(-1, 512)[ops[5] == 0] == 1e30).all()
        assert (ktri.view(-1, 512)[ops[5] == 0] == 0).all()
    if early_out:
        res = trace_cluster.item_sweeps(*args, mode, mxu=mxu)
        swept, items, pairs = res["swept"], res["items"], res["pairs"]
        w = trace_cluster.ITEM_RAYS
        assert wrapper.launches == before + 1
        assert items.shape == (ops[5].shape[0], 512 // w)
        assert torch.equal(res["t"], kt) and torch.equal(res["tri"], ktri)
        assert torch.equal(swept, swept_k)
        assert torch.equal(res["order"], trace_cluster.work_order(ops[5]))
        assert torch.equal(items.amax(dim=1), swept)
        assert int(items.sum()) * w * 256 <= pairs
        assert pairs <= int(swept.sum()) * 512 * 256


@pytest.mark.parametrize("with_fwd2", [True, False])
def test_dense_sweep_kernel_bit_exact(cuda, with_fwd2):
    """K4 on small shells, with a dead block and without an inner shell."""
    outer = outward_sphere(16, 32, 1.2).to_tensors(cuda)
    inner = outward_sphere(16, 32, 0.8).to_tensors(cuda)
    empty = outward_sphere(0, 0, 1.0).to_tensors(cuda)
    o, d = _rays(cuda, n=4000)
    o[:, -600:] = 3.0 * d[:, -600:]          # pointing away: a dead block
    for inner_mesh in (inner, empty):
        ops = traversal.dense_sweep_operands(outer, inner_mesh, o, d)
        assert ops[4].min().item() == 0 and ops[4].max().item() == 1
        before = trace_pallas.sweep_shells_dense.launches
        ker = trace_pallas.sweep_shells_dense(*ops[:4], with_fwd2, ops[4])
        assert trace_pallas.sweep_shells_dense.launches == before + 1
        twin = trace_pallas.sweep_shells_dense_twin(*ops[:4], with_fwd2,
                                                    ops[4])
        assert ker.shape[0] == (5 if with_fwd2 else 4)
        assert torch.equal(ker, twin)
        assert (ker[0] < 1e30).sum() > 500


# The matrix formulation (NR_TRACE_MXU=1): kernels against their twins to
# the JAX package's kernel-against-twin bounds (tests/test_trace_mxu.py:
# 128-136), and against the default kernels to its MXU-against-oracle
# bounds: the dense trace's in all three modes (:73-83), the sweeps' and
# the two-level trace's (:161-165, :204-212).
_TWIN_BOUNDS = dict(rtol=1e-6, atol=1e-6, ids=0.999)
_DENSE_VPU_BOUNDS = dict(rtol=1e-5, atol=1e-5, ids=0.999)
_VPU_BOUNDS = dict(rtol=1e-5, atol=1e-6, ids=0.99)


def _hold(t_a, t_b, bounds, ids_a=None, ids_b=None, min_hits=200):
    a = trace_mxu.agreement(t_a, t_b, ids_a, ids_b, bounds["rtol"],
                            bounds["atol"])
    assert a["flips"] < 2e-3 and a["both"] >= min_hits, a
    assert a["within"] and a["ids"] >= bounds["ids"], a


def _hold_rows(a, b, bounds):
    for row in range(a.shape[0]):
        _hold(a[row], b[row], bounds, min_hits=0)


@pytest.mark.parametrize("mode", [traversal.ANY, traversal.FORWARD_ONLY,
                                  traversal.BACKWARD_ONLY])
def test_dense_mxu_kernel_matches_twin(cuda, mode):
    """K8 against its twin and against K3 on the same operands."""
    outer, _ = _shells(cuda)
    o, d = _rays(cuda, n=4000)
    active = torch.rand(4000, generator=torch.Generator().manual_seed(1)) \
        .to(cuda) < 0.9
    ops = traversal.dense_trace_operands(outer, o, d, active)
    before = trace_mxu.trace_dense_mxu.launches
    ker = trace_pallas.trace_dense(*ops[:3], mode, ops[3], mxu=True)
    assert trace_mxu.trace_dense_mxu.launches == before + 1
    twin = trace_pallas.trace_dense_twin(*ops[:3], mode, ops[3], mxu=True)
    vpu = trace_pallas.trace_dense(*ops[:3], mode, ops[3], mxu=False)
    ids = [x[1].view(torch.int32) for x in (ker, twin, vpu)]
    assert torch.equal(ker, twin)
    _hold(ker[0], twin[0], _TWIN_BOUNDS, ids[0], ids[1])
    _hold(ker[0], vpu[0], _DENSE_VPU_BOUNDS, ids[0], ids[2])


@pytest.mark.parametrize("with_fwd2", [True, False])
def test_sweep_mxu_kernel_matches_twin(cuda, with_fwd2, monkeypatch):
    """K1-MXU, reached through NR_TRACE_MXU=1, against its twin and K1."""
    outer, inner = _shells(cuda)
    ops = traversal.clustered_sweep_operands(outer, inner, *_rays(cuda))
    monkeypatch.setenv("NR_TRACE_MXU", "1")
    before = trace_cluster.sweep_clusters_stream_mxu.launches
    ker = trace_cluster.sweep_clusters_stream(*ops, with_fwd2=with_fwd2)
    assert trace_cluster.sweep_clusters_stream_mxu.launches == before + 1
    twin = trace_cluster.sweep_clusters_twin(*ops, with_fwd2, mxu=True)
    vpu = trace_cluster.sweep_clusters_stream(*ops, with_fwd2=with_fwd2,
                                              mxu=False)
    assert ker.shape[0] == (5 if with_fwd2 else 4)
    assert (ker[0] < 1e30).sum() > 500
    _hold_rows(ker, twin, _TWIN_BOUNDS)
    _hold_rows(ker, vpu, _VPU_BOUNDS)


@pytest.mark.parametrize("early_out", [True, False])
@pytest.mark.parametrize("mode", [traversal.ANY, traversal.FORWARD_ONLY])
def test_clustered_trace_mxu_kernel_matches_twin(cuda, mode, early_out):
    """K5-MXU on a 9,216-triangle sphere against its twin and K5."""
    mesh = outward_sphere(48, 96, 1.0).to_tensors(cuda)
    o, d = _rays(cuda, n=4000, seed=11)
    order = traversal._ray_sort_order(o, d, None)
    ops = traversal.clustered_trace_operands(mesh, o[:, order], d[:, order])
    args = ops[:7]
    before = trace_cluster.trace_clusters_stream_mxu.launches
    kt, ktri = trace_cluster.trace_clusters_stream(*args, mode, early_out,
                                                   mxu=True)
    assert trace_cluster.trace_clusters_stream_mxu.launches == before + 1
    tt, ttri = trace_cluster.trace_clusters_twin(*args, mode, early_out,
                                                 mxu=True)
    vt, vtri = trace_cluster.trace_clusters_stream(*args, mode, early_out,
                                                   mxu=False)
    _hold(kt, tt, _TWIN_BOUNDS, ktri, ttri, min_hits=500)
    _hold(kt, vt, _VPU_BOUNDS, ktri, vtri, min_hits=500)


@pytest.mark.parametrize("with_fwd2", [True, False])
def test_dense_sweep_mxu_kernel_matches_twin(cuda, with_fwd2):
    """K4-MXU on small shells, with a dead block, against its twin and K4."""
    outer = outward_sphere(16, 32, 1.2).to_tensors(cuda)
    inner = outward_sphere(16, 32, 0.8).to_tensors(cuda)
    o, d = _rays(cuda, n=4000)
    o[:, -600:] = 3.0 * d[:, -600:]          # pointing away: a dead block
    ops = traversal.dense_sweep_operands(outer, inner, o, d)
    before = trace_pallas.sweep_shells_dense_mxu.launches
    ker = trace_pallas.sweep_shells_dense(*ops[:4], with_fwd2, ops[4],
                                          mxu=True)
    assert trace_pallas.sweep_shells_dense_mxu.launches == before + 1
    twin = trace_pallas.sweep_shells_dense_twin(*ops[:4], with_fwd2, ops[4],
                                                mxu=True)
    vpu = trace_pallas.sweep_shells_dense(*ops[:4], with_fwd2, ops[4],
                                          mxu=False)
    assert (ker[0] < 1e30).sum() > 500
    assert torch.equal(ker, twin)
    _hold_rows(ker, vpu, _VPU_BOUNDS)


def _two_lobes(device, stacks):
    """Two spheres of radius 0.5 at x = -0.6 and 0.6: a non-convex outer
    shell that rays along x cross forward twice."""
    tp = outward_sphere(stacks, 2 * stacks, 0.5).to_tensors("cpu")
    tp = tp.tris_packed[:, :tp.num_triangles].numpy()
    a, b = tp.copy(), tp.copy()
    a[0] -= 0.6
    b[0] += 0.6
    return convert.mesh_from_numpy(np.concatenate([a, b], axis=1),
                                   2 * tp.shape[1], device=device)


def test_sweep_mxu_kernels_second_crossing(cuda):
    """The strict second forward row of K1-MXU and K4-MXU, on a two-lobe
    outer shell with rays along its axis."""
    r = np.random.default_rng(23)
    o = np.stack([np.full(4096, -3.0), *r.uniform(-0.3, 0.3, (2, 4096))])
    d = np.stack([np.ones(4096), *r.uniform(-0.05, 0.05, (2, 4096))])
    o = torch.as_tensor(o.astype(np.float32), device=cuda)
    d = torch.as_tensor((d / np.linalg.norm(d, axis=0)).astype(np.float32),
                        device=cuda)
    inner = outward_sphere(4, 8, 0.3).to_tensors(cuda)
    outer = _two_lobes(cuda, 24)
    ops = traversal.clustered_sweep_operands(outer, inner, o, d)
    ker = trace_cluster.sweep_clusters_stream(*ops, with_fwd2=True, mxu=True)
    twin = trace_cluster.sweep_clusters_twin(*ops, True, mxu=True)
    vpu = trace_cluster.sweep_clusters_stream(*ops, with_fwd2=True,
                                              mxu=False)
    assert (ker[4] < 1e30).sum() > 3000
    _hold_rows(ker, twin, _TWIN_BOUNDS)
    _hold_rows(ker, vpu, _VPU_BOUNDS)
    ops = traversal.dense_sweep_operands(_two_lobes(cuda, 8), inner, o, d)
    ker = trace_pallas.sweep_shells_dense(*ops[:4], True, ops[4], mxu=True)
    twin = trace_pallas.sweep_shells_dense_twin(*ops[:4], True, ops[4],
                                                mxu=True)
    vpu = trace_pallas.sweep_shells_dense(*ops[:4], True, ops[4], mxu=False)
    assert (ker[4] < 1e30).sum() > 3000
    assert torch.equal(ker, twin)
    _hold_rows(ker, vpu, _VPU_BOUNDS)


def _dense_mxu_case(device, case):
    """Operands of the dense matrix-form kernels (K8, K4-MXU) for one launch
    shape: `one_block` (a single live 512-ray block: the triangles split
    into slices of one chunk each), `dead_between` (live, dead, live
    blocks), `ragged` (shells of 1,000 and 600 triangles, whose padding
    fills part of a chunk, and 8,192 rays, whose slice count divides
    neither chunk count) and `many_waves` (262,144 rays: one slice).
    Returns (origins, dirs, outer, inner)."""
    outer = outward_sphere(24, 48, 1.2).to_tensors(device)
    inner = outward_sphere(24, 48, 0.8).to_tensors(device)
    if case == "ragged":
        outer, inner = (convert.mesh_from_numpy(
            m.tris_packed[:, :k].cpu().numpy(), k, device=device)
            for m, k in ((outer, 1000), (inner, 600)))
    n = {"one_block": 512, "dead_between": 1536, "ragged": 8192,
         "many_waves": 262144}[case]
    o, d = _rays(device, n=n, seed=29)
    if case == "dead_between":
        o[:, 512:1024] = 3.0 * d[:, 512:1024]    # pointing away: dead
    return o, d, outer, inner


_DENSE_CASES = ["one_block", "dead_between", "ragged", "many_waves"]


def _dense_twin(twin, o, d, chunk=32768):
    """A dense twin over whole 512-ray blocks of at most `chunk` rays."""
    return torch.cat([twin(o[:, i:i + chunk], d[:, i:i + chunk],
                           slice(i // 512, (i + chunk) // 512))
                      for i in range(0, o.shape[1], chunk)], dim=1)


@pytest.mark.parametrize("mode", [traversal.ANY, traversal.FORWARD_ONLY,
                                  traversal.BACKWARD_ONLY])
@pytest.mark.parametrize("case", _DENSE_CASES)
def test_dense_mxu_kernel_shapes_bit_exact(cuda, case, mode):
    """K8 bit-exact to its twin on every launch shape: the slices' fold, a
    dead block between live ones, a ragged triangle count, many waves."""
    o, d, outer, _ = _dense_mxu_case(cuda, case)
    o, d, tp, mask = traversal.dense_trace_operands(outer, o, d)
    if case == "dead_between":
        assert mask.tolist() == [1, 0, 1]
    slices = trace_pallas.dense_scratch("trace_dense_mxu", o, tp.shape[1],
                                        2)[1]
    assert (slices > 1) == (case != "many_waves")
    ker = trace_mxu.trace_dense_mxu(o, d, tp, mode, mask)
    twin = _dense_twin(lambda a, b, blk: trace_pallas.trace_dense_twin(
        a, b, tp, mode, mask[blk], mxu=True), o, d)
    assert torch.equal(ker, twin)
    assert (ker[0] < 1e30).sum() > o.shape[1] // 8


@pytest.mark.parametrize("name", ["trace_dense_mxu", "sweep_dense_mxu"])
def test_dense_mxu_launch_shape(cuda, name):
    """Each dense matrix-form library sizes its own launch (csrc/mt_mxu.cuh::
    nr_dx_shape): it splits the triangles until its 64-ray CTAs fill 8 a
    SM, at most one slice per 64-triangle chunk, and a full launch takes
    one slice; the feature scratch holds 24 doubles a triangle."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for npad in (512, 8192, 131072, 262144):
        for ttot in (256, 2560, 9216):
            rays = torch.empty((3, npad), device=cuda)
            _, slices, feat, part = trace_pallas.dense_scratch(name, rays,
                                                               ttot, 5)
            ctas = npad // 64
            assert 1 <= slices <= ttot // 64
            assert slices * ctas >= 8 * sms or slices == ttot // 64
            assert slices == 1 or (slices - 1) * ctas < 8 * sms
            assert feat.numel() == 24 * ttot
            assert part.shape == ((slices, 5, npad) if slices > 1
                                  else (0, 5, npad))
    rays = torch.empty((3, 262144), device=cuda)
    assert trace_pallas.dense_scratch(name, rays, 9216, 2)[1] == 1


@pytest.mark.parametrize("with_fwd2", [True, False])
@pytest.mark.parametrize("case", _DENSE_CASES)
def test_dense_sweep_mxu_kernel_shapes_bit_exact(cuda, case, with_fwd2):
    """K4-MXU bit-exact to its twin on every row and launch shape."""
    o, d, outer, inner = _dense_mxu_case(cuda, case)
    ops = traversal.dense_sweep_operands(outer, inner, o, d)
    if case == "dead_between":
        assert ops[4].tolist() == [1, 0, 1]
    ker = trace_pallas.sweep_shells_dense_mxu(*ops[:4], with_fwd2, ops[4])
    twin = _dense_twin(lambda a, b, blk: trace_pallas.sweep_shells_dense_twin(
        a, b, ops[2], ops[3], with_fwd2, ops[4][blk], mxu=True),
        ops[0], ops[1])
    assert torch.equal(ker, twin)
    assert (ker[0] < 1e30).sum() > o.shape[1] // 8


# The FP32 dense kernels K3 and K4 (csrc/mt_dense.cuh): 512-ray CTAs,
# 64-triangle chunks, a prefilter before the divide and, for short
# launches, triangle slices folded per ray; bit-exact to their twins.
def _dense_fp32_case(device, case):
    """Operands of the FP32 dense kernels for one launch shape: `one_block`
    (512 rays, a single live skip block: the most slices), `padded_block`
    (4,000 rays: the last skip block is partly padding rays; a CTA is one
    whole skip block, so no CTA is partial within one),
    `dead_between` (live, dead, live skip blocks), `slice_ties` (512 rays
    against a shell whose every triangle appears twice, the copy 2,304
    ids later, so equal t's fall in different slices), `wide` (131,072
    rays) and `many_waves` (2,097,152 rays, a 1080p frame's: one slice).
    Returns (origins, dirs, outer, inner)."""
    outer = outward_sphere(24, 48, 1.2).to_tensors(device)
    inner = outward_sphere(24, 48, 0.8).to_tensors(device)
    if case == "slice_ties":
        tp = outer.tris_packed[:, :outer.num_triangles].cpu().numpy()
        outer = convert.mesh_from_numpy(np.concatenate([tp, tp], axis=1),
                                        2 * tp.shape[1], device=device)
    n = {"one_block": 512, "padded_block": 4000, "dead_between": 1536,
         "slice_ties": 512, "wide": 131072, "many_waves": 2 ** 21}[case]
    o, d = _rays(device, n=n, seed=31)
    if case == "dead_between":
        o[:, 512:1024] = 3.0 * d[:, 512:1024]    # pointing away: dead
    return o, d, outer, inner


_DENSE_FP32_CASES = ["one_block", "padded_block", "dead_between",
                     "slice_ties", "wide", "many_waves"]


@pytest.mark.parametrize("mode", [traversal.ANY, traversal.FORWARD_ONLY,
                                  traversal.BACKWARD_ONLY])
@pytest.mark.parametrize("case", _DENSE_FP32_CASES)
def test_dense_kernel_shapes_bit_exact(cuda, case, mode):
    """K3 bit-exact to its twin on every launch shape, in every mode: the
    slices' fold (where equal t's of duplicate triangles in different
    slices must keep the smallest id), padding rays in the last block, a
    dead block between live ones, many CTAs."""
    o, d, outer, _ = _dense_fp32_case(cuda, case)
    o, d, tp, mask = traversal.dense_trace_operands(outer, o, d)
    if case == "dead_between":
        assert mask.tolist() == [1, 0, 1]
    slices = trace_pallas.dense_scratch("trace_dense", o, tp.shape[1], 2)[1]
    assert (slices == 1) == (case == "many_waves")
    if case in ("one_block", "slice_ties"):
        assert slices == tp.shape[1] // 64
    before = trace_pallas.trace_dense.launches
    ker = trace_pallas.trace_dense(o, d, tp, mode, mask, mxu=False)
    assert trace_pallas.trace_dense.launches == before + 1
    twin = _dense_twin(lambda a, b, blk: trace_pallas.trace_dense_twin(
        a, b, tp, mode, mask[blk]), o, d)
    assert torch.equal(ker, twin)
    assert (ker[0] < 1e30).sum() > o.shape[1] // 8
    if case == "slice_ties":
        hit = ker[0] < 1e30
        assert int(ker[1].view(torch.int32)[hit].max()) < 2304


@pytest.mark.parametrize("with_fwd2", [True, False])
@pytest.mark.parametrize("case", _DENSE_FP32_CASES)
def test_dense_sweep_kernel_shapes_bit_exact(cuda, case, with_fwd2):
    """K4 bit-exact to its twin on every row and launch shape (with
    `slice_ties`, an outer shell whose forward crossings come twice, in
    different slices: the strict second row must skip the copy)."""
    o, d, outer, inner = _dense_fp32_case(cuda, case)
    ops = traversal.dense_sweep_operands(outer, inner, o, d)
    if case == "dead_between":
        assert ops[4].tolist() == [1, 0, 1]
    before = trace_pallas.sweep_shells_dense.launches
    ker = trace_pallas.sweep_shells_dense(*ops[:4], with_fwd2, ops[4],
                                          mxu=False)
    assert trace_pallas.sweep_shells_dense.launches == before + 1
    twin = _dense_twin(lambda a, b, blk: trace_pallas.sweep_shells_dense_twin(
        a, b, ops[2], ops[3], with_fwd2, ops[4][blk]), ops[0], ops[1])
    assert torch.equal(ker, twin)
    assert (ker[0] < 1e30).sum() > o.shape[1] // 8


def test_dense_sweep_second_crossing_across_slices(cuda):
    """K4's strict second forward row on a two-lobe outer shell, 512 rays
    along its axis: the lobes' crossings lie in different slices."""
    r = np.random.default_rng(37)
    o = np.stack([np.full(512, -3.0), *r.uniform(-0.3, 0.3, (2, 512))])
    d = np.stack([np.ones(512), *r.uniform(-0.05, 0.05, (2, 512))])
    o = torch.as_tensor(o.astype(np.float32), device=cuda)
    d = torch.as_tensor((d / np.linalg.norm(d, axis=0)).astype(np.float32),
                        device=cuda)
    inner = outward_sphere(4, 8, 0.3).to_tensors(cuda)
    ops = traversal.dense_sweep_operands(_two_lobes(cuda, 8), inner, o, d)
    assert trace_pallas.dense_scratch("sweep_dense", ops[0],
                                      ops[2].shape[1], 5)[1] > 2
    ker = trace_pallas.sweep_shells_dense(*ops[:4], True, ops[4], mxu=False)
    twin = trace_pallas.sweep_shells_dense_twin(*ops[:4], True, ops[4])
    assert torch.equal(ker, twin)
    assert (ker[4] < 1e30).sum() > 300


@pytest.mark.parametrize("name", ["trace_dense", "sweep_dense"])
def test_dense_launch_shape(cuda, name):
    """Each FP32 dense library sizes its own launch (csrc/dense_slices.cuh::
    nr_dense_slices): it splits the triangles until its 512-ray CTAs fill
    16 a SM, at most one slice per 64-triangle chunk, and a full launch
    takes one slice; it needs no feature scratch."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for npad in (512, 4096, 131072, 262144):
        for ttot in (256, 2560, 9216):
            rays = torch.empty((3, npad), device=cuda)
            _, slices, feat, part = trace_pallas.dense_scratch(name, rays,
                                                               ttot, 5)
            ctas = npad // 512
            assert 1 <= slices <= ttot // 64
            assert slices * ctas >= 16 * sms or slices == ttot // 64
            assert slices == 1 or (slices - 1) * ctas < 16 * sms
            assert feat.numel() == 0
            assert part.shape == ((slices, 5, npad) if slices > 1
                                  else (0, 5, npad))
    rays = torch.empty((3, 2 ** 21), device=cuda)
    assert trace_pallas.dense_scratch(name, rays, 9216, 2)[1] == 1


@pytest.mark.parametrize("entry_pack", [1, 2])
def test_network_kernel_matches_twin(cuda, entry_pack):
    cfg = nbvh.NbvhConfig(lane_sublanes=16, lane_entry_pack=entry_pack)
    net = nbvh.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    with torch.no_grad():
        net.lane.mul_(1e3)
    n = 1000
    g = torch.Generator().manual_seed(2)
    x = torch.rand((12, n), generator=g).to(cuda)
    active = (torch.rand(n, generator=g) < 0.5).to(cuda)
    active[128:256] = False
    out = lane_grid_kernel.forward_lane(net, x, active=active)
    npad = 1024
    twin = lane_grid_kernel.forward_lane_twin(
        net, torch.nn.functional.pad(x, (0, npad - n)),
        lane_grid_kernel._block_mask(active, npad, cuda))[:, :n]
    assert (out[:, 128:256] == 0).all()
    rel = (out - twin).abs().max() / twin.abs().max()
    assert rel.item() < 2e-2


def _lane_net(cuda, sublanes, entry_pack):
    cfg = nbvh.NbvhConfig(lane_sublanes=sublanes, lane_entry_pack=entry_pack)
    net = nbvh.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    with torch.no_grad():
        net.lane.mul_(1e3)
    return net


# Ray counts: one ray, one short of and one past a 32-ray warp tile, one
# past a 128-ray block, and a 131,072-ray slice as the frame gives K2.
_LANE_COUNTS = [1, 31, 33, 129, 131072]


@pytest.mark.parametrize("mask", ["dead", "mixed"])
@pytest.mark.parametrize("n", _LANE_COUNTS)
@pytest.mark.parametrize("sublanes,entry_pack", [(4, 1), (4, 2), (16, 1),
                                                 (16, 2)])
def test_network_kernel_counts_and_masks(cuda, sublanes, entry_pack, n,
                                         mask):
    """K2 against its twin at ragged ray counts, both table packings and
    two table sizes: every 128-ray block without an active ray (all of them
    with `dead`) writes zeros; the rest within 2e-2 of the largest output
    (the tensor cores sum the f32 products in another order than the
    twin's matmul, so a hidden activation can move by one bf16 step). The
    wrapper launches the kernel once per call."""
    net = _lane_net(cuda, sublanes, entry_pack)
    g = torch.Generator().manual_seed(n)
    x = torch.rand((12, n), generator=g).to(cuda)
    if mask == "dead":
        active = torch.zeros(n, dtype=torch.bool, device=cuda)
    else:
        active = (torch.rand(n, generator=g) < 0.5).to(cuda)
        active[0] = True
        active[128:256] = False
    before = lane_grid_kernel.forward_lane.launches
    out = lane_grid_kernel.forward_lane(net, x, active=active)
    assert lane_grid_kernel.forward_lane.launches == before + 1
    npad = -(-n // 128) * 128
    block = lane_grid_kernel._block_mask(active, npad, cuda)
    twin = lane_grid_kernel.forward_lane_twin(
        net, torch.nn.functional.pad(x, (0, npad - n)), block)[:, :n]
    assert out.shape == twin.shape == (16, n)
    live = torch.repeat_interleave(block != 0, 128)[:n]
    assert (out[:, ~live] == 0).all()
    if mask == "dead":
        assert (out == 0).all()
        return
    assert live.any()
    rel = (out - twin).abs().max() / twin.abs().max()
    assert rel.item() < 2e-2


@pytest.mark.parametrize("n", _LANE_COUNTS)
@pytest.mark.parametrize("sublanes,entry_pack", [(4, 1), (4, 2), (16, 1),
                                                 (16, 2)])
def test_train_kernels_counts(cuda, sublanes, entry_pack, n):
    """The training forward (K2 at entry_pack 1) within 2e-2 of its twin
    and K6 against backward_twin at ragged segment counts and both master
    layouts, on segments the sampler draws from small shells under the
    training loss's cotangent (what the trainer hands K6): every gradient
    within 1e-3 of the twin's largest |grad| (f32 atomics add the table and
    dW sums in no fixed order). test_train_kernels_match_twins holds K6
    under a random cotangent."""
    scene = Scene(original_mesh=outward_sphere(16, 32, 1.0),
                  inner_shell=outward_sphere(16, 32, 0.8),
                  outer_shell=outward_sphere(16, 32, 1.2))
    meshes = [getattr(scene, m).to_tensors(cuda) for m in
              ("original_mesh", "outer_shell", "inner_shell")]
    omin, inv, radius = segment_domain(scene, cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    with torch.no_grad():
        batch = sample_segment_batch(gen, *meshes, omin, inv, n, radius, 2)
    x = batch.inputs.contiguous()
    assert x.shape == (12, n)
    net = _lane_net(cuda, sublanes, entry_pack)
    out = lane_grid_kernel.forward_train(net, x)
    twin = nbvh.mlp_forward(list(net.mlp), nbvh.encode_inputs(net, x))
    assert (out - twin).abs().max() <= 2e-2 * twin.abs().max()
    out_req = out.detach().requires_grad_(True)
    (cot,) = torch.autograd.grad(shell_losses(out_req, batch)[0], out_req)
    before = lane_grid_train_kernel.backward_lane.launches
    got = lane_grid_train_kernel.backward_lane(net, x, cot)
    assert lane_grid_train_kernel.backward_lane.launches == before + 1
    ref = lane_grid_train_kernel.backward_twin(net, x, cot)
    for a, b in zip([got[0], *got[1]], [ref[0], *ref[1]]):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 4096, 131089])
def test_fused_mlp_kernel_matches_twin(cuda, n):
    """K7 (csrc/fused_mlp.cu) against apply_fused_twin on encode_inputs'
    [N, 112] f32 rows of a seeded tcnn network: one row, a ragged tile, a
    whole one, a tile for each warpgroup, a ragged block count and several
    tiles a block: every output within 2e-2 of the largest (the share of
    rows beyond 1e-5 x max printed); apply_fused and nbvh.apply equal
    fused_mlp and launch it once per call."""
    cfg = nbvh.NbvhConfig(grid_type="tcnn")
    net = nbvh.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    with torch.no_grad():
        for t in net.grid:
            t.mul_(1e3)
    x = torch.rand((12, n), generator=torch.Generator().manual_seed(3))
    x = x.to(cuda)
    enc = nbvh.encode_inputs(net, x)
    before = fused_network.apply_fused.launches
    out = fused_network.fused_mlp(net, enc)
    assert fused_network.apply_fused.launches == before + 1
    twin = fused_network.apply_fused_twin(net, enc)
    assert out.shape == twin.shape == (16, n)
    d = (out - twin).abs()
    top = twin.abs().max()
    print(f"n {n}: max|kernel - twin| / max {float(d.max() / top):.3e}, "
          f"rows beyond 1e-5 x max "
          f"{float((d > 1e-5 * top).any(dim=0).float().mean()):.4f}")
    assert d.max() <= 2e-2 * top
    assert torch.equal(fused_network.apply_fused(net, x), out)
    assert torch.equal(nbvh.apply(net, x), out)
    assert fused_network.apply_fused.launches == before + 3


def test_fused_mlp_kernel_repeatable(cuda):
    """K7 gives the same bits on every call, on rows written just before
    (L2-hot, as encode_inputs leaves them): 40 calls on fresh copies of
    131,072 rows all equal the first. A stage released before its reads
    are ordered against the next bulk copy (fence.proxy.async) let that
    copy overwrite rows still being read on some of such calls."""
    cfg = nbvh.NbvhConfig(grid_type="tcnn")
    net = nbvh.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    with torch.no_grad():
        for t in net.grid:
            t.mul_(1e3)
    x = torch.rand((12, 131072), generator=torch.Generator().manual_seed(3))
    enc = nbvh.encode_inputs(net, x.to(cuda))
    first = fused_network.fused_mlp(net, enc)
    twin = fused_network.apply_fused_twin(net, enc)
    assert (first - twin).abs().max() <= 2e-2 * twin.abs().max()
    differ = sum(not torch.equal(fused_network.fused_mlp(net, enc.clone()),
                                 first) for _ in range(40))
    assert differ == 0


def test_train_kernels_match_twins(cuda):
    """The training forward (K2 at entry_pack 1, 32 rows) within 2e-2 of
    its twin, and K6 against backward_twin at the shipped width (S=16,
    pack 2) on 5,000 rays (not a whole number of the kernel's 32-ray
    slices): every gradient within 1e-3 of the twin's largest |grad|."""
    cfg = nbvh.NbvhConfig(lane_sublanes=16, lane_entry_pack=2)
    net = nbvh.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    with torch.no_grad():
        net.lane.mul_(1e3)
    g = torch.Generator().manual_seed(4)
    n = 5000
    x = torch.rand((12, n), generator=g).to(cuda)
    cot = torch.randn((16, n), generator=g).to(cuda)
    out = lane_grid_kernel.forward_train(net, x)
    twin = nbvh.mlp_forward(list(net.mlp), nbvh.encode_inputs(net, x))
    assert (out - twin).abs().max() / twin.abs().max() < 2e-2
    before = lane_grid_train_kernel.backward_lane.launches
    got = lane_grid_train_kernel.backward_lane(net, x, cot)
    assert lane_grid_train_kernel.backward_lane.launches == before + 1
    ref = lane_grid_train_kernel.backward_twin(net, x, cot)
    for a, b in zip([got[0], *got[1]], [ref[0], *ref[1]]):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


def test_train_steps_on_card(cuda):
    """Three steps of the trainer on small shells launch K2 and K6 and keep
    the loss finite."""
    scene = Scene(original_mesh=outward_sphere(16, 32, 1.0),
                  inner_shell=outward_sphere(16, 32, 0.8),
                  outer_shell=outward_sphere(16, 32, 1.2))
    cfg = nbvh.NbvhConfig(lane_sublanes=16)
    tcfg = TrainConfig(batch_size=4096, steps=3, segments_per_ray=2,
                       fused_kernel="on")
    omin, inv, radius = segment_domain(scene, cuda)
    state = init_train_state(tcfg, cfg, cuda)
    step = make_train_step(tcfg, cfg, *(getattr(scene, m).to_tensors(cuda)
                                        for m in ("original_mesh",
                                                  "outer_shell",
                                                  "inner_shell")),
                           omin, inv, radius, device=cuda)
    k2 = lane_grid_kernel.forward_lane.launches
    k6 = lane_grid_train_kernel.backward_lane.launches
    gen = torch.Generator(device=cuda).manual_seed(1)
    losses = [float(step(state, gen)[1]["total"]) for _ in range(3)]
    assert np.isfinite(losses).all() and state.step == 3
    assert lane_grid_kernel.forward_lane.launches == k2 + 3
    assert lane_grid_train_kernel.backward_lane.launches == k6 + 3


@pytest.mark.parametrize("mxu", [False, True])
def test_frame_matches_twin_frame(cuda, mxu, monkeypatch):
    """The frame through the CUDA kernels against the same frame through
    the twins on the CPU, in both trace formulations (NR_TRACE_MXU): under
    2% of pixels off by more than 3, mean difference under 1.0."""
    monkeypatch.setenv("NR_TRACE_MXU", "1" if mxu else "0")
    w, h = 128, 96
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        outer_h = outward_sphere(24, 48, 1.2)
        omin, omax = outer_h.bounds()
        net = nbvh.init_params(nbvh.NbvhConfig(lane_sublanes=4),
                               torch.Generator().manual_seed(0), dev)
        with torch.no_grad():
            net.lane.mul_(1e3)
        ctx = NeuralContext(outer_h.to_tensors(dev),
                            outward_sphere(24, 48, 0.8).to_tensors(dev), net)
        params = RenderParams.make(
            w, h, 1, 2, [0, 0, 3.0], [0, 0, -1.0], [1, 0, 0.0],
            [0, 1, 0.0], 0.9, Material(roughness=0.6, specular=0.3),
            scene_scale=2.0, outer_shell_min=omin,
            outer_shell_inv_extent=1.0 / (omax - omin), device=dev)
        img, _ = neural_frame.render_neural_frame(
            ctx, EnvironmentTensors.from_numpy(None, device=dev), params,
            torch.zeros((3, w * h), device=dev))
        imgs.append(img.cpu().numpy().astype(int))
    d = np.abs(imgs[0] - imgs[1])
    assert (d > 3).mean() < 0.02 and d.mean() < 1.0


def _ablation_workload(device, n=4096):
    """The ablation's workload at a test size: a 9,216-triangle outward
    sphere and rays from radius 3 aimed near its centre."""
    r = np.random.default_rng(5)
    o = r.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = r.normal(size=(n, 3)) * 0.6 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tris = outward_sphere(48, 96, 1.0).to_tensors(device).tris_packed
    return (torch.as_tensor(np.ascontiguousarray(o.T, np.float32),
                            device=device),
            torch.as_tensor(np.ascontiguousarray(d.T, np.float32),
                            device=device), tris)


@pytest.mark.parametrize("label", list(trace_ablation.TRACE_COMBOS))
def test_ablation_trace_kernel_matches_twin(cuda, label):
    """Each K9 kernel against its twin (on 4,096 rays, many triangle
    slices for the variants on K3's walk); `local`, the block and tile
    rows and `recip` against K3 too."""
    var, block, tile = trace_ablation.TRACE_COMBOS[label]
    o, d, tris = _ablation_workload(cuda)
    key = f"{var}/{block}/{tile}"
    before = trace_ablation.trace_variant.launches[key]
    ker = trace_ablation.trace_variant(o, d, tris, var, block, tile)
    assert trace_ablation.trace_variant.launches[key] == before + 1
    twin = trace_ablation.trace_variant_twin(o, d, tris, var, tile)
    assert bool((ker[0] < 1e30).any())
    if var == "recipx":
        _hold(ker[0], twin[0], dict(rtol=1e-6, atol=0.0, ids=0.999),
              ker[1].view(torch.int32), twin[1].view(torch.int32))
    else:
        assert torch.equal(ker, twin)
    if var in ("local", "recip"):
        ones = torch.ones(o.shape[1] // 512, dtype=torch.int32, device=cuda)
        k3 = trace_pallas.trace_dense(o, d, tris, traversal.ANY, ones,
                                      mxu=False)
        assert torch.equal(ker, k3)


K9_WALK = [label for label, (var, _, _) in trace_ablation.TRACE_COMBOS.items()
           if var != "probe"]


@pytest.mark.parametrize("label", K9_WALK)
def test_ablation_trace_launch_shape(cuda, label):
    """The closest-hit ablation's walk sizes its slices as nr_dense_slices
    does at its shape (`trace_ablation.walk_shape`: `block`-ray CTAs,
    tile / 2-triangle chunks, 16 x 512 / block CTAs an SM), with no
    feature scratch; it refuses a shape outside TRACE_COMBOS."""
    _, block, tile = trace_ablation.TRACE_COMBOS[label]
    cta_rays, chunk, per_sm = trace_ablation.walk_shape(block, tile)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for npad in (4096, 262144, 2 ** 21):
        rays = torch.empty((3, npad), device=cuda)
        for ttot in (2 * tile, 9216):
            _, slices, feat, part = trace_pallas.dense_scratch(
                "ablate_trace", rays, ttot, 2, shape=(block, tile))
            ctas = max(npad // cta_rays, 1)
            assert slices == min(-(-sms * per_sm // ctas),
                                 max(ttot // chunk, 1))
            assert feat.numel() == 0
            assert part.shape == ((slices, 2, npad) if slices > 1
                                  else (0, 2, npad))
    with pytest.raises(RuntimeError):
        trace_pallas.dense_scratch("ablate_trace", rays, 9216, 2,
                                   shape=(block, 64))


@pytest.mark.parametrize("label", ["local", "bf16", "b1024t512"])
def test_ablation_trace_kernel_one_slice(cuda, label):
    """A launch whose CTAs fill the card alone takes one slice, written
    without the fold (bf16's misses keep its own miss value): 2^21 rays
    against a 512-triangle sphere equal the twin (in 2^16-ray calls), and
    `local` equals K3."""
    var, block, tile = trace_ablation.TRACE_COMBOS[label]
    n = 2 ** 21
    r = np.random.default_rng(9)
    o = r.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = r.normal(size=(n, 3)) * 0.6 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.as_tensor(np.ascontiguousarray(x.T, np.float32),
                            device=cuda) for x in (o, d))
    tris = outward_sphere(16, 16, 1.0).to_tensors(cuda).tris_packed
    assert trace_pallas.dense_scratch("ablate_trace", o, tris.shape[1], 2,
                                      shape=(block, tile))[1] == 1
    ker = trace_ablation.trace_variant(o, d, tris, var, block, tile)
    step = 2 ** 16
    twin = torch.cat([trace_ablation.trace_variant_twin(
        o[:, i:i + step], d[:, i:i + step], tris, var, tile)
        for i in range(0, n, step)], dim=1)
    miss = trace_ablation.BF16_MISS if var == "bf16" else 1e30
    assert bool((twin[0] == torch.tensor(miss, device=cuda)).any())
    assert bool((twin[0] < miss).any())
    assert torch.equal(ker, twin)
    if var == "local":
        ones = torch.ones(n // 512, dtype=torch.int32, device=cuda)
        assert torch.equal(ker, trace_pallas.trace_dense(
            o, d, tris, traversal.ANY, ones, mxu=False))


@pytest.mark.parametrize("variant", trace_ablation.SWEEP_VARIANTS)
@pytest.mark.parametrize("with_fwd2", [True, False])
def test_ablation_sweep_kernel_matches_twin(cuda, variant, with_fwd2):
    """The sweep family's kernels against their twins on small shells."""
    outer = outward_sphere(16, 32, 1.2).to_tensors(cuda)
    inner = outward_sphere(16, 32, 0.8).to_tensors(cuda)
    ops = traversal.dense_sweep_operands(outer, inner, *_rays(cuda))
    before = trace_ablation.sweep_variant.launches[variant]
    ker = trace_ablation.sweep_variant(*ops[:4], with_fwd2, ops[4], variant)
    assert trace_ablation.sweep_variant.launches[variant] == before + 1
    twin = trace_pallas.sweep_shells_dense_twin(
        *ops[:4], with_fwd2, ops[4],
        pairs=trace_ablation.variant_pairs(variant))
    assert (ker[0] < 1e30).sum() > 500
    if variant == "recipx":
        _hold_rows(ker, twin, dict(rtol=1e-6, atol=0.0, ids=0.0))
    else:
        assert torch.equal(ker, twin)


@pytest.mark.parametrize("variant", trace_ablation.SWEEP_VARIANTS)
def test_ablation_sweep_second_crossing_across_slices(cuda, variant):
    """The sweep variants on K4's walk, one 512-ray block (the most
    slices) along the axis of a two-lobe outer shell: the strict second
    forward row comes from crossings in different slices."""
    r = np.random.default_rng(37)
    o = np.stack([np.full(512, -3.0), *r.uniform(-0.3, 0.3, (2, 512))])
    d = np.stack([np.ones(512), *r.uniform(-0.05, 0.05, (2, 512))])
    o = torch.as_tensor(o.astype(np.float32), device=cuda)
    d = torch.as_tensor((d / np.linalg.norm(d, axis=0)).astype(np.float32),
                        device=cuda)
    inner = outward_sphere(4, 8, 0.3).to_tensors(cuda)
    ops = traversal.dense_sweep_operands(_two_lobes(cuda, 8), inner, o, d)
    assert trace_pallas.dense_scratch("ablate_sweep", ops[0],
                                      ops[2].shape[1], 5)[1] > 2
    ker = trace_ablation.sweep_variant(*ops[:4], True, ops[4], variant)
    twin = trace_pallas.sweep_shells_dense_twin(
        *ops[:4], True, ops[4], pairs=trace_ablation.variant_pairs(variant))
    if variant == "recipx":
        _hold_rows(ker, twin, dict(rtol=1e-6, atol=0.0, ids=0.0))
    else:
        assert torch.equal(ker, twin)
    assert (ker[4] < 1e30).sum() > 100


@pytest.mark.parametrize("name, cta_rays, per_sm",
                         [("ablate_sweep", 512, 16),
                          ("ablate_mxu_bf16", 256, 48)])
def test_ablation_launch_shape(cuda, name, cta_rays, per_sm):
    """The redesigned K9 libraries size their launches as the dense
    kernels do: slices of whole 64-triangle chunks until the CTAs reach
    `per_sm` a SM, one slice for a launch that fills the card alone; the
    matrix form's feature scratch holds 256 8-byte words an 8-triangle
    n-tile."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for npad in (512, 4096, 262144, 2 ** 21):
        for ttot in (576, 9216):
            rays = torch.empty((3, npad), device=cuda)
            _, slices, feat, part = trace_pallas.dense_scratch(name, rays,
                                                               ttot, 2)
            ctas = npad // cta_rays
            assert 1 <= slices <= ttot // 64
            assert slices * ctas >= per_sm * sms or slices == ttot // 64
            assert slices == 1 or (slices - 1) * ctas < per_sm * sms
            assert feat.numel() == (ttot // 8 * 256
                                    if name == "ablate_mxu_bf16" else 0)
            assert part.shape[0] == (slices if slices > 1 else 0)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("n, stacks", [(512, 48), (4096, 12), (4096, 20)])
def test_ablation_mxu_bf16_kernel_shapes(cuda, passes, n, stacks):
    """The bf16 matrix form on one 512-ray block against 9,216 triangles
    (many slices, folded), and on 576 and 1,600 triangles (9 and 25
    chunks): within the kernel-against-twin bounds, and the same launch
    twice bit-equal."""
    r = np.random.default_rng(11)
    o = r.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = r.normal(size=(n, 3)) * 0.6 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.as_tensor(np.ascontiguousarray(x.T, np.float32),
                            device=cuda) for x in (o, d))
    tris = outward_sphere(stacks, 2 * stacks, 1.0).to_tensors(cuda) \
        .tris_packed
    ker = trace_ablation.trace_mxu_bf16(o, d, tris, passes)
    twin = trace_ablation.trace_mxu_bf16_twin(o, d, tris, passes)
    _hold(ker[0], twin[0], _TWIN_BOUNDS, ker[1].view(torch.int32),
          twin[1].view(torch.int32), min_hits=n // 4)
    assert torch.equal(ker, trace_ablation.trace_mxu_bf16(o, d, tris,
                                                          passes))


@pytest.mark.parametrize("passes", [1, 3])
def test_ablation_mxu_bf16_kernel_matches_twin(cuda, passes):
    """The bf16 matrix form (mxu_lo, mxu_hi3) against its twin."""
    o, d, tris = _ablation_workload(cuda)
    before = trace_ablation.trace_mxu_bf16.launches[passes]
    ker = trace_ablation.trace_mxu_bf16(o, d, tris, passes)
    assert trace_ablation.trace_mxu_bf16.launches[passes] == before + 1
    twin = trace_ablation.trace_mxu_bf16_twin(o, d, tris, passes)
    _hold(ker[0], twin[0], _TWIN_BOUNDS, ker[1].view(torch.int32),
          twin[1].view(torch.int32))


def _stripe_scene(dev, w=128, h=96):
    outer_h = outward_sphere(24, 48, 1.2)
    omin, omax = outer_h.bounds()
    net = nbvh.init_params(nbvh.NbvhConfig(lane_sublanes=4),
                           torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        net.lane.mul_(1e3)
    ctx = NeuralContext(outer_h.to_tensors(dev),
                        outward_sphere(24, 48, 0.8).to_tensors(dev), net)
    params = RenderParams.make(
        w, h, 1, 2, [0, 0, 3.0], [0, 0, -1.0], [1, 0, 0.0], [0, 1, 0.0],
        0.9, Material(roughness=0.6, specular=0.3), scene_scale=2.0,
        outer_shell_min=omin, outer_shell_inv_extent=1.0 / (omax - omin),
        device=dev)
    gt = outward_sphere(16, 32, 1.0).to_tensors(dev)
    return ctx, gt, EnvironmentTensors.from_numpy(None, device=dev), params


def test_stripes_equal_whole_frame_on_card(cuda):
    """Four stripes of the 128x96 neural and ground-truth frames
    (`row0` / `n_rows`, global pixel ids) stitch to the whole frame bit for
    bit on the card: image, accumulation and guides (every kernel is
    per-ray, so a ray's result does not depend on its batch)."""
    from neural_renderer_tpu_torch.render import pathtrace as pt
    ctx, gt, env, params = _stripe_scene(cuda)
    w, h, rows = 128, 96, 24
    frames = {"neural": lambda acc, **kw: neural_frame.render_neural_frame(
                  ctx, env, params, acc, return_guides=True, **kw),
              "gt": lambda acc, **kw: pt.render_gt_frame(
                  gt, env, params, acc, return_guides=True, **kw)}
    for name, fn in frames.items():
        img, acc, guides = fn(torch.zeros((3, w * h), device=cuda))
        parts = [fn(torch.zeros((3, w * rows), device=cuda), row0=r0,
                    n_rows=rows) for r0 in range(0, h, rows)]
        assert torch.equal(torch.cat([p[0] for p in parts]), img), name
        assert torch.equal(torch.cat([p[1].reshape(3, rows, w)
                                      for p in parts], dim=1),
                           acc.reshape(3, h, w)), name
        for k in (0, 1):
            assert torch.equal(torch.cat([p[2][k] for p in parts], dim=1),
                               guides[k]), name


def test_nccl_world_of_one_tiled_frame(cuda, tmp_path):
    """A world-size-1 NCCL group through the tiled functions gives the plain
    frames, the plain denoised image and compute_psnr's PSNR."""
    import torch.distributed as dist
    from neural_renderer_tpu_torch import parallel as par
    from neural_renderer_tpu_torch.metrics import compute_psnr
    from neural_renderer_tpu_torch.ops.denoise import bilateral_denoise
    from neural_renderer_tpu_torch.render import pathtrace as pt
    if not dist.is_nccl_available():
        pytest.skip("this PyTorch has no NCCL")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = par.make_mesh(dp=1)
        ctx, gt, env, params = _stripe_scene(cuda)
        acc0 = torch.zeros((3, 128 * 96), device=cuda)
        n_img, n_acc, n_g = neural_frame.render_neural_frame(
            ctx, env, params, acc0, return_guides=True)
        t_img, t_acc, t_g = par.render_neural_frame_tiled(
            ctx, env, params, acc0, mesh, return_guides=True)
        assert torch.equal(t_img, n_img) and torch.equal(t_acc, n_acc)
        g_img, _ = pt.render_gt_frame(gt, env, params, acc0)
        tg_img, _ = par.render_gt_frame_tiled(gt, env, params, acc0, mesh)
        assert torch.equal(tg_img, g_img)
        acc = n_acc.reshape(3, 96, 128)
        assert torch.equal(par.bilateral_denoise_tiled(acc, 1, *t_g, mesh),
                           bilateral_denoise(acc, 1, *n_g))
        psnr = float(par.psnr_tiled(g_img, n_img, mesh))
        want = compute_psnr(g_img.cpu().numpy(), n_img.cpu().numpy())
        assert abs(psnr - want) <= 1e-12 * want
    finally:
        dist.destroy_process_group()
