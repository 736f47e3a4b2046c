"""The shell march's "trace" variants in the port, on the CPU.

`camera_entry="trace"` (a FORWARD_ONLY entry trace of the outer shell, then
iteration 1 through the compaction) and `retry="trace"` (the exit-then-
retry entry of bounce rays that start inside the outer shell), chosen per
call or by NR_CAMERA_ENTRY / NR_ENTRY_RETRY through CAMERA_ENTRY_DEFAULT /
ENTRY_RETRY_DEFAULT, as in the JAX package.

Each variant's 32x24 frame (1 bounce) against the JAX package's frame
under the same variant (JAX under `jax.disable_jit()`), at
tests/test_torch_frame.py's tolerance: max u8 difference 2, under 5% of
pixels differ. Within the port: "derive" equals "trace" bit for bit on
tests/test_shell_sweep.py's mixed inside/outside rays (the JAX package
pins the same there), the "trace" camera entry agrees with "fwd2" but for
boundary-ulp rays (tests/test_march_compaction.py's rule, stated at the
test), and a march
of rays given without an entry (camera_rays=False) equals the march given
`_shell_entry_from_rays`' entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.render import neural_march as jmarch
from neural_renderer_tpu.render.neural_frame import \
    render_neural_frame as jframe
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

torch.set_num_threads(1)

_CAM = dict(cam_pos=[0, 0, 3.0], cam_forward=[0, 0, -1.0],
            cam_right=[1, 0, 0.0], cam_up=[0, 1, 0.0], fov_y=0.9,
            scene_scale=2.0)
W, H = 32, 24


@pytest.fixture(scope="module")
def scene():
    """tests/test_torch_frame.py's scene: shells (24, 48) of radius 1.2 /
    0.8, the seeded lane network (S=4) with bf16-rounded tables."""
    om, im = outward_sphere(24, 48, 1.2), outward_sphere(24, 48, 0.8)
    oa, ia = om.to_arrays(), im.to_arrays()
    jcfg = jnbvh.NbvhConfig(grid_type="lane", lane_sublanes=4)
    jp = jnbvh.init_params(jax.random.PRNGKey(0), jcfg)
    jp["lane"] = (jp["lane"] * 1e3).astype(jnp.bfloat16).astype(jnp.float32)
    net = convert.params_from_numpy(
        {"lane": np.asarray(jp["lane"]),
         "mlp": [np.asarray(w) for w in jp["mlp"]]},
        nbvh.NbvhConfig(lane_sublanes=4), device="cpu")
    meshes = [convert.mesh_from_numpy(np.asarray(a.tris_packed),
                                      a.num_triangles, device="cpu")
              for a in (oa, ia)]
    omin, omax = om.bounds()
    bounds = dict(outer_shell_min=omin,
                  outer_shell_inv_extent=1.0 / (omax - omin))
    return (jmarch.NeuralContext(outer=oa, inner=ia, net_params=jp,
                                 config=jcfg),
            neural_march.NeuralContext(meshes[0], meshes[1], net), bounds)


def _params(bounds, w=W, h=H, bounces=1):
    return RenderParams.make(w, h, 1, bounces, device="cpu",
                             material=Material(roughness=0.6, specular=0.3),
                             **_CAM, **bounds)


@pytest.mark.parametrize("name,value", [("CAMERA_ENTRY_DEFAULT", "trace"),
                                        ("ENTRY_RETRY_DEFAULT", "trace")])
def test_variant_frame_matches_jax(scene, monkeypatch, name, value):
    """The frame under one "trace" variant, set in both packages' module
    default (where NR_CAMERA_ENTRY / NR_ENTRY_RETRY land), against JAX."""
    jctx, ctx, bounds = scene
    monkeypatch.setattr(jmarch, name, value)
    monkeypatch.setattr(neural_march, name, value)
    jm = JMaterial.default()
    jm.roughness.value, jm.specular.value = 0.6, 0.3
    jparams = JParams.make(W, H, 1, 1, material=jm, **_CAM, **bounds)
    with jax.disable_jit():
        ref, _ = jframe(jctx, Mesh().to_arrays(),
                        EnvironmentMap().to_arrays(), jparams,
                        jnp.zeros((3, W * H), jnp.float32))
    img, _ = neural_frame.render_neural_frame(
        ctx, EnvironmentTensors.from_numpy(None, device="cpu"),
        _params(bounds), torch.zeros((3, W * H)))
    diff = np.abs(img.numpy().astype(int) - np.asarray(ref).astype(int))
    assert diff.max() <= 2
    assert (diff.sum(axis=-1) > 0).mean() < 0.05
    assert np.asarray(ref).std() > 1.0


def _mixed_rays(n=4096, seed=11):
    """tests/test_shell_sweep.py::test_entry_retry_derive_matches_trace's
    rays: half the origins between the shells, half outside; pdf 0 on a
    tenth, a sixth inactive."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = np.where(rng.random(n) < 0.5, rng.uniform(0.85, 1.15, n),
                 rng.uniform(1.5, 3.0, n))
    o = torch.as_tensor((u * r[:, None]).T, dtype=torch.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = torch.as_tensor(d.T, dtype=torch.float32)
    pdf = torch.as_tensor(np.where(rng.random(n) < 0.9, rng.random(n) + 0.1,
                                   0.0), dtype=torch.float32)
    dist = torch.as_tensor(rng.random(n) + 0.05, dtype=torch.float32)
    active = torch.as_tensor(rng.random(n) < 0.85)
    return o, d, pdf, dist, active


def test_derive_equals_trace(scene):
    """retry="derive" equals retry="trace" bit for bit, in the fused bounce
    stage and in _shell_entry_from_rays, on rays of which some start
    inside the outer shell without a forward crossing."""
    from neural_renderer_tpu_torch.ops import traversal
    _, ctx, _ = scene
    o, d, pdf, dist, active = _mixed_rays()
    rays = pt.BounceRays(origin=o, direction=d, pdf=pdf,
                         brdf_weight=torch.zeros_like(o), distance=dist)
    for fn, args in (
            (neural_march.bounce_shell_entry_and_early_term,
             (ctx, rays, active)),
            (neural_march._shell_entry_from_rays,
             (ctx.outer, o, d, active, pdf))):
        got, ref = fn(*args, retry="derive"), fn(*args, retry="trace")
        flat = (lambda x: [x[0], *x[1]]) if fn is not \
            neural_march._shell_entry_from_rays else list
        for g, r in zip(flat(got), flat(ref)):
            assert torch.equal(g, r)
    sw = traversal.sweep_shells(ctx.outer, ctx.inner, o, d)
    inside = (sw.outer_fwd >= 1e30) & (sw.outer_bwd < 1e30)
    assert int(inside.sum()) > 100


def _aimed_rays(n, seed, miss=0.0):
    """Rays from radius 3 toward N(0, 0.5^2) points, a share `miss` of
    them moved 10 to the side."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0
    t = rng.normal(size=(n, 3)) * 0.5
    t[rng.random(n) < miss] += np.array([10.0, 0.0, 0.0])
    d = t - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.T, dtype=torch.float32),
            torch.as_tensor(d.T, dtype=torch.float32))


def test_camera_entry_trace_agrees_with_fwd2(scene):
    """The "trace" camera entry against "fwd2" on 4,096 rays aimed so that
    most miss (iteration 1 then runs on a small compacted share), with a
    freshly seeded network (tables within 1e-4, as initialised: the scaled
    tables above turn the ulps by which the two entries' iteration-1 sweeps
    differ into bf16 roundings of the network's activations): tests/
    test_march_compaction.py's rule, hits differing on under 1% of the
    rays, positions and distances within 1e-4 relative and 1e-4 absolute
    where both hit, but on at most 1% of those rays, each within 1e-3: the
    port's network runs in bf16 (JAX's test in f32), and where an ulp of
    input flips the bf16 rounding of an activation the output moves by up
    to ~1e-3 (2 of 1,258 rays here). The trace variant's compaction equals
    its full batch exactly."""
    _, ctx, bounds = scene
    o, d = _aimed_rays(4096, 3, miss=0.7)
    params = _params(bounds, 64, 64)
    ctx = neural_march.NeuralContext(ctx.outer, ctx.inner, nbvh.init_params(
        nbvh.NbvhConfig(lane_sublanes=4), torch.Generator().manual_seed(2),
        "cpu"))

    def run(mode, comp):
        return neural_march.trace_neural_segments(
            ctx, params, o, d, compaction=comp, camera_entry=mode)
    a, b, bc = run("fwd2", False), run("trace", False), run("trace", True)
    for x, y in zip(b, bc):
        assert torch.equal(x, y)
    assert (a.hit != b.hit).float().mean() < 0.01
    both = a.hit & b.hit
    assert int(both.sum()) > 300
    for x, y in ((a.position[:, both], b.position[:, both]),
                 (a.distance[both], b.distance[both])):
        off = ((x - y).abs() > 1e-4 + 1e-4 * y.abs()).reshape(-1, x.shape[-1])
        assert off.any(dim=0).float().mean() <= 0.01
        assert (x - y).abs().max() <= 1e-3


def test_rays_without_entry_take_shell_entry_from_rays(scene):
    """trace_neural_segments(camera_rays=False) equals the march given
    _shell_entry_from_rays' entry."""
    _, ctx, bounds = scene
    o, d = _aimed_rays(1024, 7)
    rng = np.random.default_rng(8)
    pdf = torch.as_tensor(np.where(rng.random(1024) < 0.9, 1.0, 0.0),
                          dtype=torch.float32)
    active = torch.as_tensor(rng.random(1024) < 0.85)
    params = _params(bounds, 8, 8)
    a = neural_march.trace_neural_segments(
        ctx, params, o, d, ray_active=active, pdfs=pdf, camera_rays=False,
        compaction=False)
    entry = neural_march._shell_entry_from_rays(ctx.outer, o, d, active, pdf)
    b = neural_march.trace_neural_segments(ctx, params, o, d, entry=entry,
                                           compaction=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(entry[1].sum()) > 300 and int(a.hit.sum()) > 10
