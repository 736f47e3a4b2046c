"""The port's stage profiler against the JAX package's, on the CPU.

The JAX profiler runs under `jax.disable_jit()` (its stage programs op by
op). Held: the ground-truth profile and the per-bounce frame times fill
the same categories and keys as the JAX ones on the same scene; the
neural profile fills the categories the JAX neural profile fills without
an additional mesh (its JAX run takes ~18 s here, so the set is written
out). The staged ground-truth and neural chains, which the profiler runs
stage by stage, end in exactly the image the whole frame renders.
`evaluate --profile` is tests/test_torch_viewer.py's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.render import profiler as jprof
from neural_renderer_tpu.render.neural_march import NeuralContext as JCtx
from neural_renderer_tpu.render.params import RenderParams as JParams
from neural_renderer_tpu.scene.envmap import EnvironmentMap
from neural_renderer_tpu.scene.materials import Material as JMaterial
from neural_renderer_tpu.scene.mesh import Mesh

from util import outward_sphere

from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.render import neural_march, profiler
from neural_renderer_tpu_torch.render import pathtrace as pt
from neural_renderer_tpu_torch.render.neural_frame import render_neural_frame
from neural_renderer_tpu_torch.render.params import RenderParams
from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
from neural_renderer_tpu_torch.scene.materials import Material

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

_CAM = dict(cam_pos=[0, 0, 3.0], cam_forward=[0, 0, -1.0],
            cam_right=[1, 0, 0.0], cam_up=[0, 1, 0.0], fov_y=1.0,
            scene_scale=2.0)
# What the JAX profile_neural_frame fills without an additional mesh.
NEURAL_CATEGORIES = {"shellTrace", "neuralForward", "initPathState",
                     "sampleBounce", "earlyTermination", "integrateBounce",
                     "finalize"}


def _filled(t):
    return {k for k, v in t.ms.items() if v > 0}


def _carry_gt(a):
    n = np.asarray
    return convert.mesh_from_numpy(
        n(a.tris_packed), a.num_triangles, device="cpu",
        vertices=n(a.vertices), normals=n(a.normals), uvs=n(a.uvs),
        indices=n(a.indices), tri_material=n(a.tri_material),
        nodes_packed=n(a.nodes_packed), mat_scalars=n(a.mat_scalars),
        has_normals=a.has_normals, has_uvs=a.has_uvs,
        has_materials=a.has_materials, max_leaf=a.max_leaf)


@pytest.fixture(scope="module")
def shells():
    """Shells (6, 12) of radius 1.2 / 0.8 with a seeded lane network (S=4),
    on both sides."""
    om = outward_sphere(6, 12, 1.2)
    oa, ia = om.to_arrays(), outward_sphere(6, 12, 0.8).to_arrays()
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
    return (neural_march.NeuralContext(meshes[0], meshes[1], net),
            JCtx(outer=oa, inner=ia, net_params=jp, config=jcfg), bounds)


def _env():
    return EnvironmentTensors.from_numpy(None, device="cpu")


def test_gt_profile_fills_jax_categories():
    a = outward_sphere(6, 12, 1.0).to_arrays()
    with jax.disable_jit():
        jp = JParams.make(8, 8, 1, 2, material=JMaterial.default(), **_CAM)
        want = jprof.profile_gt_frame(a, EnvironmentMap().to_arrays(), jp,
                                      runs=1)
    p = RenderParams.make(8, 8, 1, 2, material=Material(), device="cpu",
                          **_CAM)
    t = profiler.profile_gt_frame(_carry_gt(a), _env(), p, runs=1)
    assert profiler.CATEGORIES == jprof.CATEGORIES
    assert len(profiler.CATEGORIES) == 13
    assert _filled(t) == _filled(want)
    assert t.ray_count == want.ray_count == 64
    assert t.frame_total_ms > 0 and t.ns_per_ray("primaryTrace") > 0
    table = t.table()
    assert "primaryTrace" in table and "ns/ray" in table \
        and "frame total" in table


def test_neural_profile_by_bounce_matches_jax_keys(shells):
    ctx, jctx, bounds = shells
    with jax.disable_jit():
        jp = JParams.make(8, 8, 1, 1, material=JMaterial.default(), **_CAM,
                          **bounds)
        want = jprof.profile_neural_frame_by_bounce(
            jctx, Mesh().to_arrays(), EnvironmentMap().to_arrays(), jp,
            runs=1)
    p = RenderParams.make(8, 8, 1, 1, material=Material(), device="cpu",
                          **_CAM, **bounds)
    got = profiler.profile_neural_frame_by_bounce(ctx, None, _env(), p,
                                                  runs=1)
    assert set(got) == set(want)
    assert len(got["frame_ms"]) == len(want["frame_ms"]) == 2
    assert len(got["bounce_ms"]) == len(want["bounce_ms"]) == 1
    assert got["ray_count"] == want["ray_count"] == 64
    assert all(m > 0 for m in got["frame_ms"])

    t = profiler.profile_neural_frame(ctx, None, _env(), p, runs=1)
    assert _filled(t) == NEURAL_CATEGORIES
    # Measured: the live rows one frame hands the network.
    rows = []
    real = nbvh.apply

    def spy(net, inputs, active=None):
        rows.append(inputs.shape[1] if active is None
                    else int(active.sum()))
        return real(net, inputs, active=active)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nbvh, "apply", spy)
        render_neural_frame(ctx, _env(), p,
                            torch.zeros((3, 64), device="cpu"))
    assert t.neural_ray_calls == sum(rows) > 0
    assert t.neural_calls_per_ray == sum(rows) / 64
    assert f"avg neural calls/ray: {sum(rows) / 64:.2f}" in t.table()


@pytest.mark.parametrize("neural", [False, True])
def test_staged_chain_gives_the_frame(shells, monkeypatch, neural):
    """The profiler's stage-by-stage chain ends in the frame's image: the
    first `finalize` call of a profile (the chain's warm-up) against the
    whole frame's first (its warm-up), bit for bit."""
    ctx, _, bounds = shells
    calls = []
    real = pt.finalize

    def spy(params, radiance, accum):
        out = real(params, radiance, accum)
        calls.append(out)
        return out

    monkeypatch.setattr(pt, "finalize", spy)
    p = RenderParams.make(12, 10, 2, 2, material=Material(roughness=0.5),
                          device="cpu", **_CAM, **bounds)
    if neural:
        profiler.profile_neural_frame(ctx, None, _env(), p, runs=1)
    else:
        mesh = _carry_gt(outward_sphere(6, 12, 1.0).to_arrays())
        profiler.profile_gt_frame(mesh, _env(), p, runs=1)
    # Chain warm-up + 1, frame warm-up + 1; the neural profile renders one
    # more frame, untimed, to count the network's rows.
    assert len(calls) == (5 if neural else 4)
    staged, frame = calls[0], calls[2]
    assert torch.equal(staged[0], frame[0])
    assert torch.equal(staged[1], frame[1])
    assert (frame[0] != frame[0][0, 0]).any()
