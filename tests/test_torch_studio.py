"""The studio scene through the port against the JAX package, on the CPU.

`configs/studio/studio_lane.json`: the textured, normal-mapped glTF torus
(2,304 triangles), torus shells of 800 + 800 triangles (the dense sweep,
K4's twin), the `extra.obj` additional mesh (398 triangles: a ground plane
and a side sphere, traced by the dense closest hit, K3's twin), the PIZ
sky (256x128 half) and the trained lane grid (`lane_step12000.npz`, S=16,
entry_pack 2). Both packages load the config themselves; their BVH builds
give the same triangle order (checked), so ids agree.

- The ground-truth frame (32x24, 1 spp, the config's 3 bounces) through
  the port's `Renderer` against JAX's `render_gt_frame` under
  `jax.disable_jit()`. Measured: equal (0 u8 steps); held to at most 1
  step on at most 1% of pixels.
- The hybrid merge of camera rays: the torus's and the additional mesh's
  FORWARD_ONLY hits merged by `select_closest_hits`, against JAX: hit
  masks, albedo and material rows exact; positions, normals and distances
  within 2e-6 relative (the camera rays agree to 2 ulp,
  tests/test_torch_foundation.py, and torch's CPU sqrt is not correctly
  rounded).
- The hybrid bounce stage: compacted equals full batch bit for bit, the
  additional mesh's own material rows scattered back (not the global row
  that the march's hits carry).
- The hybrid neural frame (32x24, trained weights, bounce compaction on)
  against JAX's: measured 1 u8 step on 1 pixel (0.13%), held to at most 1
  step on at most 1% of pixels. The JAX frame takes 25-40 s op by op, over
  this file's budget, so the test is marked slow.
The JAX side's lane tables are rounded to bf16: the port, like the TPU
kernel, reads them packed as bf16 at entry_pack 2, while JAX's XLA path on
the CPU reads f32.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.config import load_config as jload
from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.ops import traversal as jtr
from neural_renderer_tpu.render import pathtrace as jpt
from neural_renderer_tpu.render.neural_frame import \
    render_neural_frame as jframe
from neural_renderer_tpu.render.neural_march import NeuralContext as JCtx
from neural_renderer_tpu.render.params import RenderParams as JParams
from neural_renderer_tpu.scene.scene import Scene as JScene

from neural_renderer_tpu_torch.config import (camera_basis_from_state,
                                              load_config,
                                              matrix_to_camera_state)
from neural_renderer_tpu_torch.ops import traversal as ttr
from neural_renderer_tpu_torch.render import neural_frame
from neural_renderer_tpu_torch.render import pathtrace as tpt
from neural_renderer_tpu_torch.render.neural_march import NeuralContext
from neural_renderer_tpu_torch.render.renderer import RenderBasis, Renderer
from neural_renderer_tpu_torch.scene.scene import Scene

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "studio", "studio_lane.json")
W, H = 32, 24


@pytest.fixture(scope="module")
def studio():
    """(JAX scene, JAX params, port Renderer, camera position) of
    studio_lane.json at W x H, 1 spp, the config's bounces."""
    jcfg = jload(CONFIG)
    js = JScene.from_config(jcfg, sphere_fallback=False)
    cfg = load_config(CONFIG)
    pos, yaw, pitch = matrix_to_camera_state(cfg.camera.matrix)
    fwd, right, up, fov = camera_basis_from_state(yaw, pitch,
                                                  cfg.camera.yfov)
    omin, omax = js.outer_shell.bounds()
    smin, smax = js.original_mesh.bounds()
    jp = JParams.make(
        width=W, height=H, samples_per_pixel=1,
        max_bounces=jcfg.rendering.bounce_count, cam_pos=pos,
        cam_forward=fwd, cam_right=right, cam_up=up, fov_y=fov,
        material=js.global_material, sample_offset=0,
        scene_scale=float(np.linalg.norm(smax - smin)),
        outer_shell_min=omin, outer_shell_inv_extent=1.0 / (omax - omin))
    rend = Renderer(Scene.from_config(cfg), cfg.neural_network,
                    device="cpu")
    rend.resize(W, H)
    rend.set_bounce_count(cfg.rendering.bounce_count)
    rend.set_camera_basis(RenderBasis(fwd, right, up, fov))
    assert rend.load_weights_from_file(cfg.checkpoint_path)
    return js, jp, rend, pos


def _u8_diff(img, ref):
    d = np.abs(np.asarray(img, np.int64) - np.asarray(ref, np.int64))
    share = float((d.sum(axis=-1) > 0).mean())
    print(f"max u8 difference {d.max()}, share of pixels differing "
          f"{share:.4f}")
    return d, share


def test_scene_loads_like_jax(studio):
    js, _, rend, _ = studio
    scene = rend.scene
    assert scene.environment_error is None and scene.failed_meshes == []
    env = rend._env_tensors()
    assert (env.width, env.height, env.is_valid) == (256, 128, True)
    np.testing.assert_array_equal(env.pixels.numpy(),
                                  js.environment.pixels.reshape(-1, 3).T)
    gt = rend._mesh_tensors("original_mesh")
    assert gt.has_textures and gt.has_normal_maps and gt.texture_nearest
    for name in ("original_mesh", "outer_shell", "inner_shell",
                 "additional_mesh"):
        np.testing.assert_array_equal(
            rend._mesh_tensors(name).tris_packed.numpy(),
            np.asarray(getattr(js, name).to_arrays().tris_packed), name)
    assert [rend._mesh_tensors(n).num_triangles for n in (
        "original_mesh", "outer_shell", "inner_shell",
        "additional_mesh")] == [2304, 800, 800, 398]


def test_gt_frame_matches_jax(studio):
    js, jp, rend, pos = studio
    with jax.disable_jit():
        ref, _ = jpt.render_gt_frame(
            js.original_mesh.to_arrays(), js.environment.to_arrays(), jp,
            jnp.zeros((3, W * H), jnp.float32))
    rend.set_use_neural_query(False)
    img = rend.render(pos)
    assert img.shape == (H, W, 3) and img.std() > 5.0
    d, share = _u8_diff(img, ref)
    assert d.max() <= 1 and share <= 0.01


def test_hybrid_camera_merge_matches_jax(studio):
    """The merge of the hybrid branch on camera rays, on real hits: the
    torus's (textured, normal-mapped) and the additional mesh's, both
    FORWARD_ONLY, as the neural frame merges its camera hits."""
    js, jp, rend, pos = studio
    params = rend._build_params(pos, 0)
    _, _, _, o, d = tpt.primary_rays(params)
    a = tpt.trace_rays_mesh(rend._mesh_tensors("original_mesh"), params, o,
                            d, ttr.FORWARD_ONLY)
    b = tpt.trace_rays_mesh(rend._mesh_tensors("additional_mesh"), params,
                            o, d, ttr.FORWARD_ONLY)
    got = tpt.select_closest_hits(params, a, b, o)
    with jax.disable_jit():
        _, _, _, jo, jd = jpt.primary_rays(jp)
        ja = jpt.trace_rays_mesh(js.original_mesh.to_arrays(), jp, jo, jd,
                                 jtr.FORWARD_ONLY)
        jb = jpt.trace_rays_mesh(js.additional_mesh.to_arrays(), jp, jo, jd,
                                 jtr.FORWARD_ONLY)
        want = jpt.select_closest_hits(jp, ja, jb, jo)
    assert bool(a.hit.any()) and bool(b.hit.any())
    assert bool((b.hit & ~a.hit).any()) and bool((a.hit & b.hit).any())
    for name in ("albedo", "material_params", "hit"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    for name in ("position", "normal", "distance"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        print(f"{name}: max |port - JAX| {np.abs(a - b).max()!r}")
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-6, err_msg=name)


def test_hybrid_bounce_stage_compacted_equals_full(studio):
    """With the additional mesh, the compacted bounce stage scatters the
    merged hits back: bit-equal to the full-batch stage, whose bounce hits
    on the additional mesh carry that mesh's material, not the global
    row."""
    _, _, rend, pos = studio
    params = rend._build_params(pos, 0)
    ctx = NeuralContext(rend._mesh_tensors("outer_shell"),
                        rend._mesh_tensors("inner_shell"), rend.net)
    add = rend._mesh_tensors("additional_mesh")
    pix, samp, _, o, d = tpt.primary_rays(params)
    hits = tpt.trace_rays_mesh(add, params, o, d, ttr.FORWARD_ONLY)
    rays = tpt.sample_bounce_directions(params, pix, samp, hits, hits.hit,
                                        None)
    active = hits.hit & (rays.pdf > 0)
    full = neural_frame._bounce_stage_compacted(ctx, params, add, rays,
                                                active, compaction=False)
    comp = neural_frame._bounce_stage_compacted(ctx, params, add, rays,
                                                active, compaction=True)
    for a, b in zip(full[0], comp[0]):
        assert torch.equal(a, b)
    assert torch.equal(full[1], comp[1])
    plain = neural_frame._bounce_stage_compacted(ctx, params, None, rays,
                                                 active, compaction=True)
    hit = comp[0].hit
    assert bool(hit.any()) and bool((hit & ~plain[0].hit).any())
    assert not torch.equal(comp[0].material_params[:, hit],
                           plain[0].material_params[:, hit])


@pytest.mark.slow
def test_hybrid_neural_frame_matches_jax(studio):
    js, jp, rend, pos = studio
    lane = jnp.asarray(rend.net.lane.numpy()).astype(jnp.bfloat16) \
        .astype(jnp.float32)
    jnet = {"lane": lane, "mlp": [jnp.asarray(w.numpy())
                                  for w in rend.net.mlp]}
    jcfg = jnbvh.NbvhConfig(log2_hashmap_size=14, base_resolution=16,
                            grid_type="lane", lane_sublanes=16,
                            lane_entry_pack=2)
    ctx = JCtx(outer=js.outer_shell.to_arrays(),
               inner=js.inner_shell.to_arrays(), net_params=jnet,
               config=jcfg)
    with jax.disable_jit():
        ref, _ = jframe(ctx, js.additional_mesh.to_arrays(),
                        js.environment.to_arrays(), jp,
                        jnp.zeros((3, W * H), jnp.float32),
                        use_additional=True, bounce_compaction=True)
    tctx = NeuralContext(rend._mesh_tensors("outer_shell"),
                         rend._mesh_tensors("inner_shell"), rend.net)
    img, accum = neural_frame.render_neural_frame(
        tctx, rend._env_tensors(), rend._build_params(pos, 0),
        torch.zeros((3, W * H)), use_additional=True,
        bounce_compaction=True,
        additional_mesh=rend._mesh_tensors("additional_mesh"))
    assert torch.isfinite(accum).all() and img.float().std() > 5.0
    d, share = _u8_diff(img.numpy(), ref)
    assert d.max() <= 1 and share <= 0.01
