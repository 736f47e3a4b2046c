"""The port's denoiser and the frames' guide buffers against the JAX
package, on the CPU.

Denoiser: the same seeded inputs go through both; the linear stencil core
within 1e-5 relative of the JAX core's largest value, the u8 image at most
1 step apart (a value on a rounding boundary may truncate either way), and
tests/test_denoise_parallel.py's three properties held on the port.
Guides: the ground-truth frame's guides (the BVH closest hit, run op by op
on both sides) agree to 1e-5 on pixels hit on both sides, with at most 1%
of the hit masks flipped by grazing rays; the neural frame's (the march
with its bf16 network) within the march's own spread: the hit masks alike
on 99% of the pixels, normals within 2e-2 and albedo within 1e-2 on 99%
of the pixels hit on both sides. The Renderer's denoised frame is
`bilateral_denoise` of its accumulation and guides, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.ops import denoise as jdn
from neural_renderer_tpu.ops.srgb import encode_srgb_u8 as jencode
from neural_renderer_tpu.render.neural_frame import \
    render_neural_frame as jframe
from neural_renderer_tpu.render.neural_march import NeuralContext as JCtx
from neural_renderer_tpu.render.params import RenderParams as JParams
from neural_renderer_tpu.render.pathtrace import render_gt_frame as jgt
from neural_renderer_tpu.scene.envmap import EnvironmentMap
from neural_renderer_tpu.scene.materials import Material as JMaterial
from neural_renderer_tpu.scene.mesh import Mesh

from util import outward_sphere

from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.models.convert import mesh_from_numpy
from neural_renderer_tpu_torch.ops import denoise
from neural_renderer_tpu_torch.ops.srgb import encode_srgb_u8
from neural_renderer_tpu_torch.render import neural_frame, neural_march
from neural_renderer_tpu_torch.render.params import RenderParams
from neural_renderer_tpu_torch.render.pathtrace import render_gt_frame
from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
from neural_renderer_tpu_torch.scene.materials import Material

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

W, H = 24, 16
_CAM = dict(cam_pos=[0.2, 0.1, 3.0], cam_forward=[0, 0, -1.0],
            cam_right=[1, 0, 0.0], cam_up=[0, 1, 0.0], fov_y=0.9,
            scene_scale=2.0)


def _chw(x):
    return torch.as_tensor(np.ascontiguousarray(x.transpose(2, 0, 1)))


def _jax_denoise(color, count, normals, albedo):
    return np.asarray(jdn.bilateral_denoise(
        jnp.asarray(color.transpose(2, 0, 1)), jnp.float32(count),
        jnp.asarray(normals.transpose(2, 0, 1)),
        jnp.asarray(albedo.transpose(2, 0, 1))))


def _port_denoise(color, count, normals, albedo):
    return denoise.bilateral_denoise(_chw(color), count, _chw(normals),
                                     _chw(albedo)).numpy()


def _guided_inputs(seed, h=H, w=W):
    """HDR sums of 3 samples with a few fireflies; unit normals in four
    facets; albedo in two materials."""
    r = np.random.default_rng(seed)
    accum = (3 * r.gamma(2.0, 0.2, (h, w, 3))).astype(np.float32)
    accum[r.uniform(size=(h, w)) < 0.03] *= 40.0
    facet = (np.arange(h)[:, None] * 2 // h) * 2 + np.arange(w) * 2 // w
    dirs = r.normal(size=(4, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    normals = (dirs[facet] + r.normal(scale=0.05, size=(h, w, 3)))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    albedo = np.where((np.arange(w) < w // 3)[None, :, None], 0.2, 0.7) \
        + r.normal(scale=0.02, size=(h, w, 3))
    return accum, normals.astype(np.float32), albedo.astype(np.float32)


def test_constants_match_jax():
    assert (denoise.DENOISE_RADIUS, denoise.SIGMA_SPATIAL,
            denoise.NORMAL_ALPHA, denoise.SIGMA_ALBEDO) == (
        jdn.DENOISE_RADIUS, jdn.SIGMA_SPATIAL, jdn.NORMAL_ALPHA,
        jdn.SIGMA_ALBEDO) == (5, 3.0, 64.0, 0.1)


@pytest.mark.parametrize("seed", [0, 1])
def test_core_matches_jax(seed):
    """_bilateral_core on the same padded arrays, with a valid plane that
    marks a halo row as real (the stripe case) and the rest as padding."""
    accum, normals, albedo = _guided_inputs(seed)
    r, h, w = denoise.DENOISE_RADIUS, H, W
    pad = ((r, r), (r, r), (0, 0))
    cp, npd, ap = (np.pad(x, pad) for x in (accum / 3.0, normals, albedo))
    rng = np.random.default_rng(seed + 10)
    cp[:r] = rng.uniform(size=cp[:r].shape)   # a neighbour stripe's rows
    valid = np.pad(np.ones((h, w), np.float32), r)
    valid[:r, r:r + w] = 1.0
    want = np.asarray(jdn._bilateral_core(
        *(jnp.asarray(x.transpose(2, 0, 1)) for x in (cp, npd, ap)),
        jnp.asarray(valid), h, w))
    got = denoise._bilateral_core(
        *(_chw(x) for x in (cp, npd, ap)), torch.as_tensor(valid), h,
        w).numpy()
    assert got.shape == (3, h, w)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("seed", [0, 1])
def test_denoise_u8_matches_jax(seed):
    accum, normals, albedo = _guided_inputs(seed)
    want = _jax_denoise(accum, 3.0, normals, albedo)
    got = _port_denoise(accum, 3.0, normals, albedo)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (got != _port_denoise(accum, 1.0, normals, albedo)).any()


def test_denoise_flat_region_reduces_noise(rng):
    """Uniform guides: pure spatial filtering; the noise shrinks, the mean
    stays."""
    h, w = 24, 32
    noisy = 0.4 + rng.normal(scale=0.15, size=(h, w, 3)).astype(np.float32)
    normals = np.zeros((h, w, 3), np.float32)
    normals[..., 1] = 1.0
    albedo = np.full((h, w, 3), 0.5, np.float32)
    out = _port_denoise(noisy, 1.0, normals, albedo).astype(np.float32) / 255
    raw = encode_srgb_u8(torch.as_tensor(noisy)).numpy().astype(
        np.float32) / 255.0
    assert out[5:-5, 5:-5].std() < 0.3 * raw[5:-5, 5:-5].std()
    assert abs(out[5:-5, 5:-5].mean() - raw[5:-5, 5:-5].mean()) < 0.05


def test_denoise_preserves_normal_edges():
    """Different guide normals across an edge: no bleeding."""
    h, w = 16, 32
    color = np.zeros((h, w, 3), np.float32)
    color[:, :w // 2] = 0.1
    color[:, w // 2:] = 0.9
    normals = np.zeros((h, w, 3), np.float32)
    normals[:, :w // 2, 0] = 1.0
    normals[:, w // 2:, 1] = 1.0
    albedo = np.full((h, w, 3), 0.5, np.float32)
    out = _port_denoise(color, 1.0, normals, albedo).astype(np.float32) / 255
    assert out[:, :w // 2 - 1].mean() < 0.45
    assert out[:, w // 2 + 1:].mean() > 0.8


def test_denoise_accum_normalization():
    """accum holds sums; the count divides them."""
    accum = np.full((8, 8, 3), 4 * 0.25, np.float32)
    normals = np.zeros((8, 8, 3), np.float32)
    normals[..., 2] = 1.0
    out = _port_denoise(accum, 4.0, normals,
                        np.zeros((8, 8, 3), np.float32)) / 255.0
    expected = float(np.asarray(jencode(jnp.asarray([0.25])))[0]) / 255.0
    assert abs(out.mean() - expected) < 0.01


# ---------------------------------------------------------------------------
# Guide buffers
# ---------------------------------------------------------------------------

def _guides_close(got, want, hit_got, hit_want, tol, share):
    """got/want: (normals, albedo) [3, H, W]; on the pixels hit on both
    sides, each guide within tol[i] on at least `share` of them."""
    both = hit_got & hit_want
    assert (hit_got != hit_want).mean() <= 0.01 and both.mean() > 0.1
    for g, w, t in zip(got, want, tol):
        err = np.abs(np.asarray(g) - np.asarray(w)).max(axis=0)[both]
        assert (err <= t).mean() >= share, (err.max(), (err <= t).mean())


def _carry_gt(a):
    n = np.asarray
    return mesh_from_numpy(
        n(a.tris_packed), a.num_triangles, device="cpu",
        vertices=n(a.vertices), normals=n(a.normals), uvs=n(a.uvs),
        indices=n(a.indices), tri_material=n(a.tri_material),
        nodes_packed=n(a.nodes_packed), mat_scalars=n(a.mat_scalars),
        has_normals=a.has_normals, has_uvs=a.has_uvs,
        has_materials=a.has_materials, max_leaf=a.max_leaf)


def test_gt_guides_match_jax():
    a = outward_sphere(8, 16, 1.0).to_arrays()
    with jax.disable_jit():
        jp = JParams.make(W, H, 2, 1, material=JMaterial.default(), **_CAM)
        jimg, _, jguides = jgt(a, EnvironmentMap().to_arrays(), jp,
                               jnp.zeros((3, W * H), jnp.float32),
                               return_guides=True)
    p = RenderParams.make(W, H, 2, 1, material=Material(), device="cpu",
                          **_CAM)
    img, accum, guides = render_gt_frame(
        _carry_gt(a), EnvironmentTensors.from_numpy(None, device="cpu"), p,
        torch.zeros((3, W * H)), return_guides=True)
    assert all(tuple(g.shape) == (3, H, W) for g in guides)
    hit = guides[0].abs().sum(0).numpy() > 0
    jhit = np.abs(np.asarray(jguides[0])).sum(0) > 0
    _guides_close([g.numpy() for g in guides], jguides, hit, jhit,
                  (1e-5, 1e-5), 1.0)
    # Without guides the frame is the same.
    img2, accum2 = render_gt_frame(
        _carry_gt(a), EnvironmentTensors.from_numpy(None, device="cpu"), p,
        torch.zeros((3, W * H)))
    assert torch.equal(img, img2) and torch.equal(accum, accum2)


@pytest.fixture(scope="module")
def shells():
    """tests/test_torch_frame.py's scene: outward sphere shells (12, 24)
    of radius 1.2 / 0.8 and a lane network (S=4), its tables rounded to
    bf16 as the port reads them."""
    om, im = outward_sphere(12, 24, 1.2), outward_sphere(12, 24, 0.8)
    oa, ia = om.to_arrays(), im.to_arrays()
    jcfg = jnbvh.NbvhConfig(grid_type="lane", lane_sublanes=4)
    jp = jnbvh.init_params(jax.random.PRNGKey(0), jcfg)
    jp["lane"] = (jp["lane"] * 1e3).astype(jnp.bfloat16).astype(jnp.float32)
    omin, omax = om.bounds()
    bounds = dict(outer_shell_min=omin,
                  outer_shell_inv_extent=1.0 / (omax - omin))
    net = convert.params_from_numpy(
        {"lane": np.asarray(jp["lane"]),
         "mlp": [np.asarray(w) for w in jp["mlp"]]},
        nbvh.NbvhConfig(lane_sublanes=4), device="cpu")
    meshes = [convert.mesh_from_numpy(np.asarray(a.tris_packed),
                                      a.num_triangles, device="cpu")
              for a in (oa, ia)]
    ctx = neural_march.NeuralContext(meshes[0], meshes[1], net)
    jctx = JCtx(outer=oa, inner=ia, net_params=jp, config=jcfg)
    return ctx, jctx, bounds


def test_neural_guides_match_jax(shells):
    ctx, jctx, bounds = shells
    jm = JMaterial.default()
    jm.roughness.value = 0.6
    with jax.disable_jit():
        jp = JParams.make(W, H, 1, 1, material=jm, **_CAM, **bounds)
        jimg, _, jguides = jframe(jctx, Mesh().to_arrays(),
                                  EnvironmentMap().to_arrays(), jp,
                                  jnp.zeros((3, W * H), jnp.float32),
                                  return_guides=True)
    p = RenderParams.make(W, H, 1, 1, material=Material(roughness=0.6),
                          device="cpu", **_CAM, **bounds)
    img, _, guides = neural_frame.render_neural_frame(
        ctx, EnvironmentTensors.from_numpy(None, device="cpu"), p,
        torch.zeros((3, W * H)), return_guides=True)
    hit = guides[0].abs().sum(0).numpy() > 0
    jhit = np.abs(np.asarray(jguides[0])).sum(0) > 0
    _guides_close([g.numpy() for g in guides], jguides, hit, jhit,
                  (2e-2, 1e-2), 0.99)
    diff = np.abs(img.numpy().astype(int) - np.asarray(jimg).astype(int))
    assert diff.max() <= 2


def test_renderer_denoised_frame_is_bilateral_of_accumulation():
    """Renderer.set_denoise: two more frames of the lane sphere scene, on
    the ground-truth and the neural branch; the image
    is bilateral_denoise of the accumulation and the guides the frame
    returned, and render_accumulate refuses the denoised view."""
    import os
    from neural_renderer_tpu_torch.config import (camera_basis_from_state,
                                                  load_config,
                                                  matrix_to_camera_state)
    from neural_renderer_tpu_torch.render.renderer import (RenderBasis,
                                                           Renderer)
    from neural_renderer_tpu_torch.scene.scene import Scene
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "sphere",
                                   "sphere_lane.json"))
    rend = Renderer(Scene.from_config(cfg), cfg.neural_network,
                    device="cpu")
    assert rend.load_weights_from_file(cfg.checkpoint_path)
    pos, yaw, pitch = matrix_to_camera_state(cfg.camera.matrix)
    rend.set_camera_basis(RenderBasis(*camera_basis_from_state(
        yaw, pitch, cfg.camera.yfov)))
    rend.resize(W, H)
    rend.set_bounce_count(2)
    for neural in (True, False):
        rend.set_use_neural_query(neural)
        plain = [rend.render(pos) for _ in range(2)][-1]
        rend.set_denoise(True)
        img = [rend.render(pos) for _ in range(2)][-1]
        # The toggle keeps the accumulation, as the JAX Renderer's does.
        assert rend.accum_sample_count == 4
        want = denoise.bilateral_denoise(rend._accum.reshape(3, H, W), 4,
                                         *rend._guides).numpy()
        np.testing.assert_array_equal(img, want)
        assert (img != plain).any()
        with pytest.raises(ValueError, match="denoise"):
            rend.render_accumulate(pos, 2)
        rend.set_denoise(False)
