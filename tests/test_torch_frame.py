"""The port's whole neural frame against the JAX frame, on the CPU.

Same scene (outward UV-sphere shells (24, 48) of radius 1.2 / 0.8: 4,608
triangles, the clustered sweep branch), the same lane network (S=4, pack 2)
carried with `params_from_numpy`, tables pre-rounded to bf16 so the packed
entries equal the JAX XLA path's f32 ones. 32x24, 1 spp, 2 bounces. The
JAX frame runs under `jax.disable_jit()`: op by op it takes ~11 s where its
jit compile alone took 26-52 s, and it rounds like the port's eager ops.
Held to the cross-backend tolerance of tests/test_golden.py:99-101: max u8
difference <= 2, under 5% of pixels differ. The same frame with
NR_TRACE_MXU=1 (the matrix formulation of every trace and sweep) is held to
the same JAX frame within tests/test_frame_interpret.py::_compare's bounds.
The CUDA frame is held to the twin frame on the GPU by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.render.neural_frame import \
    render_neural_frame as jframe
from neural_renderer_tpu.render.neural_march import NeuralContext as JCtx
from neural_renderer_tpu.render.params import RenderParams as JParams
from neural_renderer_tpu.scene.envmap import EnvironmentMap
from neural_renderer_tpu.scene.materials import Material as JMaterial
from neural_renderer_tpu.scene.mesh import Mesh

from util import outward_sphere

from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.render import neural_frame, neural_march
from neural_renderer_tpu_torch.render import pathtrace as pt
from neural_renderer_tpu_torch.render.params import RenderParams
from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
from neural_renderer_tpu_torch.scene.materials import Material

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

_CAM = dict(cam_pos=[0, 0, 3.0], cam_forward=[0, 0, -1.0],
            cam_right=[1, 0, 0.0], cam_up=[0, 1, 0.0], fov_y=0.9,
            scene_scale=2.0)


@pytest.fixture(scope="module")
def scene():
    om, im = outward_sphere(24, 48, 1.2), outward_sphere(24, 48, 0.8)
    oa, ia = om.to_arrays(), im.to_arrays()
    jcfg = jnbvh.NbvhConfig(grid_type="lane", lane_sublanes=4)
    jp = jnbvh.init_params(jax.random.PRNGKey(0), jcfg)
    jp["lane"] = (jp["lane"] * 1e3).astype(jnp.bfloat16).astype(jnp.float32)
    omin, omax = om.bounds()
    bounds = dict(outer_shell_min=omin, outer_shell_inv_extent=1.0 / (omax -
                                                                     omin))
    return om, oa, ia, jcfg, jp, bounds


def _port_ctx(scene, device):
    _, oa, ia, _, jp, _ = scene
    net = convert.params_from_numpy(
        {"lane": np.asarray(jp["lane"]),
         "mlp": [np.asarray(w) for w in jp["mlp"]]},
        nbvh.NbvhConfig(lane_sublanes=4), device=device)
    meshes = [convert.mesh_from_numpy(np.asarray(a.tris_packed),
                                      a.num_triangles, device=device)
              for a in (oa, ia)]
    return neural_march.NeuralContext(meshes[0], meshes[1], net)


def _port_params(scene, w, h, bounces, device):
    return RenderParams.make(w, h, 1, bounces, device=device,
                             material=Material(roughness=0.6, specular=0.3),
                             **_CAM, **scene[5])


@pytest.fixture(scope="module")
def jax_frame(scene):
    """The JAX package's frame of the default path, run op by op."""
    _, oa, ia, jcfg, jp, bounds = scene
    w, h = 32, 24
    jm = JMaterial.default()
    jm.roughness.value, jm.specular.value = 0.6, 0.3
    jparams = JParams.make(w, h, 1, 2, material=jm, **_CAM, **bounds)
    ctx = JCtx(outer=oa, inner=ia, net_params=jp, config=jcfg)
    with jax.disable_jit():
        ref, _ = jframe(ctx, Mesh().to_arrays(), EnvironmentMap().to_arrays(),
                        jparams, jnp.zeros((3, w * h), jnp.float32))
    return np.asarray(ref)


@pytest.mark.parametrize("mxu", [False, True])
def test_frame_matches_jax(scene, jax_frame, mxu, monkeypatch):
    """The port's frame against the JAX frame of the default path. With
    NR_TRACE_MXU=1 the port traces in the matrix formulation and is held to
    tests/test_frame_interpret.py::_compare's bounds (under 2% of pixels off
    by more than 3 u8 steps, mean difference under 1), the bounds to which
    JAX's own test_neural_frame_full_tpu_path[mxu] holds its MXU frame
    against the same reference. The JAX MXU frame itself runs only on the
    TPU branch, forced there in Pallas interpret mode: 93.6 s on the CPU
    (the ground-truth one 11.6 s), beyond this file's budget."""
    monkeypatch.setenv("NR_TRACE_MXU", "1" if mxu else "0")
    w, h = 32, 24
    img, accum = neural_frame.render_neural_frame(
        _port_ctx(scene, "cpu"), EnvironmentTensors.from_numpy(None,
                                                               device="cpu"),
        _port_params(scene, w, h, 2, "cpu"), torch.zeros((3, w * h)))
    assert img.dtype == torch.uint8 and tuple(img.shape) == (h, w, 3)
    assert torch.isfinite(accum).all()
    diff = np.abs(img.numpy().astype(int) - jax_frame.astype(int))
    print(f"mxu {mxu}: max u8 difference {diff.max()}, share of pixels "
          f"differing {(diff.sum(axis=-1) > 0).mean():.4f}, share off by "
          f"more than 3 {(diff > 3).mean():.4f}, mean {diff.mean():.4f}")
    if mxu:
        assert (diff > 3).mean() < 0.02 and diff.mean() < 1.0
    else:
        assert diff.max() <= 2
        assert (diff.sum(axis=-1) > 0).mean() < 0.05


def test_compaction_equals_full_batch(scene):
    """Dynamic-shape compaction (march iterations and the bounce stage)
    gives the full batch's result: per-ray math is batch-position
    independent."""
    ctx = _port_ctx(scene, "cpu")
    params = _port_params(scene, 72, 60, 2, "cpu")
    _, _, _, origins, dirs = pt.primary_rays(params)
    full = neural_march.trace_neural_segments(ctx, params, origins, dirs,
                                              compaction=False)
    comp = neural_march.trace_neural_segments(ctx, params, origins, dirs,
                                              compaction=True)
    for a, b in zip(full, comp):
        assert torch.equal(a, b)
    env = EnvironmentTensors.from_numpy(None, device="cpu")
    acc = torch.zeros((3, 72 * 60))
    img_f, _ = neural_frame.render_neural_frame(ctx, env, params, acc,
                                                bounce_compaction=False)
    img_c, _ = neural_frame.render_neural_frame(ctx, env, params, acc,
                                                bounce_compaction=True)
    assert torch.equal(img_f, img_c)


def test_hybrid_branch_not_ported(scene):
    with pytest.raises(NotImplementedError):
        neural_frame.render_neural_frame(
            _port_ctx(scene, "cpu"), None, _port_params(scene, 8, 8, 1,
                                                        "cpu"),
            torch.zeros((3, 64)), use_additional=True)
