"""The port's CUDA kernels against their PyTorch twins, on a GPU.

Imports no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit. The repository's conftest.py imports JAX, so run it with:

    python -m pytest --noconftest tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one. Tolerances: the four
trace and sweep kernels are built with -fmad=false and evaluate the twin's
expressions in the twin's order, so they are held bit-exact; the network
kernel sums its bf16 products in another order than the twin's f32 matmul,
so it is held to max|d| / max|twin| < 2e-2; the training backward kernel
adds its f32 sums by atomics in no fixed order, so each gradient is held to
1e-3 of the twin's largest |grad|; whole frames to
tests/test_frame_interpret.py's tolerance.
"""

import numpy as np
import pytest
import torch

from neural_renderer_tpu_torch.models import nbvh
from neural_renderer_tpu_torch.ops import (lane_grid_kernel,
                                           lane_grid_train_kernel,
                                           trace_cluster, trace_pallas,
                                           traversal)
from neural_renderer_tpu_torch.render import neural_frame
from neural_renderer_tpu_torch.render.neural_march import NeuralContext
from neural_renderer_tpu_torch.render.params import RenderParams
from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
from neural_renderer_tpu_torch.scene.materials import Material
from neural_renderer_tpu_torch.scene.mesh import outward_sphere
from neural_renderer_tpu_torch.scene.scene import Scene
from neural_renderer_tpu_torch.train import (TrainConfig, init_train_state,
                                             make_train_step, segment_domain)

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


def test_frame_matches_twin_frame(cuda):
    """The frame through the CUDA kernels against the same frame through
    the twins on the CPU: under 2% of pixels off by more than 3, mean
    difference under 1.0."""
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
