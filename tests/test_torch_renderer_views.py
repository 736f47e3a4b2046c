"""The viewer's part of the port's Renderer and `evaluate`'s flags, on the
CPU.

Against the JAX package (under `jax.disable_jit()`): the neural Lambert
view, held to the neural frame's bounds (tests/test_torch_frame.py: max u8
difference 2, under 5% of pixels differ); the Renderer's ground-truth
frame with the classic-mesh index, the environment strength and the direct
environment colour set, held to tests/test_golden.py's tolerance (the same
bounds); `memory_stats`' keys and triangle counts.
Within the port: render_accumulate's image does not depend on
chunk_batches and `progress` fires once per chunk; `evaluate --host-loop`
writes the chunked path's images; an uneven sample count renders, equal
to the same samples in batches of one; `--profile` prints one table per
pass; `--dp 0` is refused by name (`--dp 2` runs in
tests/test_torch_parallel_render.py).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu import config as jconfig
from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.render.neural_frame import \
    render_neural_lambert as jlambert
from neural_renderer_tpu.render.neural_march import NeuralContext as JCtx
from neural_renderer_tpu.render.params import RenderParams as JParams
from neural_renderer_tpu.render.renderer import Renderer as JRenderer
from neural_renderer_tpu.scene.envmap import EnvironmentMap
from neural_renderer_tpu.scene.materials import Material as JMaterial
from neural_renderer_tpu.scene.mesh import Mesh
from neural_renderer_tpu.scene.scene import Scene as JScene

from torch_scenes import tiny_config
from util import outward_sphere

from neural_renderer_tpu_torch import config
from neural_renderer_tpu_torch.cli import evaluate
from neural_renderer_tpu_torch.metrics import load_image
from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.render import neural_frame, neural_march
from neural_renderer_tpu_torch.render.params import RenderParams
from neural_renderer_tpu_torch.render.renderer import RenderBasis, Renderer
from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
from neural_renderer_tpu_torch.scene.materials import Material
from neural_renderer_tpu_torch.scene.scene import Scene

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 24, 16
_CAM = dict(cam_pos=[0.2, 0.1, 3.0], cam_forward=[0, 0, -1.0],
            cam_right=[1, 0, 0.0], cam_up=[0, 1, 0.0], fov_y=0.9,
            scene_scale=2.0)


def _close(img, ref):
    diff = np.abs(img.astype(int) - ref.astype(int))
    assert diff.max() <= 2
    assert (diff.sum(axis=-1) > 0).mean() < 0.05
    assert (ref != ref[0, 0]).any()


def test_neural_lambert_matches_jax():
    """Outward sphere shells (12, 24), a seeded lane network (S=4, tables
    rounded to bf16 as the port reads them), 2 spp."""
    om, im = outward_sphere(12, 24, 1.2), outward_sphere(12, 24, 0.8)
    oa, ia = om.to_arrays(), im.to_arrays()
    jcfg = jnbvh.NbvhConfig(grid_type="lane", lane_sublanes=4)
    jp = jnbvh.init_params(jax.random.PRNGKey(1), jcfg)
    jp["lane"] = (jp["lane"] * 1e3).astype(jnp.bfloat16).astype(jnp.float32)
    omin, omax = om.bounds()
    bounds = dict(outer_shell_min=omin,
                  outer_shell_inv_extent=1.0 / (omax - omin))
    with jax.disable_jit():
        ref = jlambert(JCtx(outer=oa, inner=ia, net_params=jp, config=jcfg),
                       Mesh().to_arrays(), EnvironmentMap().to_arrays(),
                       JParams.make(W, H, 2, 0, material=JMaterial.default(),
                                    **_CAM, **bounds))
    net = convert.params_from_numpy(
        {"lane": np.asarray(jp["lane"]),
         "mlp": [np.asarray(w) for w in jp["mlp"]]},
        nbvh.NbvhConfig(lane_sublanes=4), device="cpu")
    meshes = [convert.mesh_from_numpy(np.asarray(a.tris_packed),
                                      a.num_triangles, device="cpu")
              for a in (oa, ia)]
    img = neural_frame.render_neural_lambert(
        neural_march.NeuralContext(meshes[0], meshes[1], net),
        EnvironmentTensors.from_numpy(None, device="cpu"),
        RenderParams.make(W, H, 2, 0, material=Material(), device="cpu",
                          **_CAM, **bounds))
    assert img.dtype == torch.uint8 and tuple(img.shape) == (H, W, 3)
    _close(img.numpy(), np.asarray(ref))


def _renderers(cfg_path, device="cpu"):
    """The port's and the JAX Renderer on one config, set alike."""
    out = []
    for mod, R, B, S in ((config, Renderer, RenderBasis, Scene),
                         (jconfig, JRenderer, None, JScene)):
        cfg = mod.load_config(cfg_path)
        if R is Renderer:
            r = R(S.from_config(cfg), cfg.neural_network, device=device)
            assert r.load_weights_from_file(cfg.checkpoint_path)
        else:
            from neural_renderer_tpu.render import RenderBasis as B
            r = R(S.from_config(cfg), cfg.neural_network)
        pos, yaw, pitch = mod.matrix_to_camera_state(cfg.camera.matrix)
        r.set_camera_basis(B(*mod.camera_basis_from_state(yaw, pitch,
                                                          cfg.camera.yfov)))
        r.resize(W, H)
        r.set_bounce_count(1)
        out.append((r, pos))
    return out


def test_renderer_settings_match_jax(tmp_path):
    """The ground-truth frame on the inner shell (classic mesh 1), at
    environment strength 0.6 with a direct environment colour, and the
    Lambert view of the outer shell, against the JAX Renderer's."""
    (rend, pos), (jrend, jpos) = _renderers(tiny_config(tmp_path))
    for r in (rend, jrend):
        r.set_use_neural_query(False)
        r.set_classic_mesh_index(1)
        r.set_env_strength(0.6)
        r.set_direct_env_color(True, (0.2, 0.3, 0.5))
    with jax.disable_jit():
        want = jrend.render(jpos)
    got = rend.render(pos)
    _close(got, want)
    np.testing.assert_array_equal(rend.device_pixels(), got)
    for r in (rend, jrend):
        r.set_lambert_view(True)
        r.set_classic_mesh_index(2)
    with jax.disable_jit():
        want = jrend.render(jpos)
    _close(rend.render(pos), want)
    assert rend.accum_sample_count == 0


def test_memory_stats_match_jax(tmp_path):
    (rend, _), (jrend, _) = _renderers(tiny_config(tmp_path))
    got, want = rend.memory_stats(), jrend.memory_stats()
    assert set(got) == set(want)
    for name in ("original_mesh", "inner_shell", "outer_shell",
                 "additional_mesh"):
        assert set(got[name]) == set(want[name])
        # The JAX arrays of an empty mesh hold one padding triangle and
        # count it; the port counts the mesh's own.
        assert got[name]["triangles"] == (
            0 if name == "additional_mesh" else want[name]["triangles"])
        assert got[name]["total_bytes"] >= got[name]["bvh_bytes"] >= 0
    assert [got[n]["triangles"] for n in ("original_mesh", "inner_shell",
                                          "outer_shell")] == [256, 144, 144]
    assert want["additional_mesh"]["triangles"] == 1
    assert got["tiled_fallback_frames"] == 0
    # The port's network: lane tables of S=2 and the MLP, f32.
    assert got["network_bytes"] == sum(
        p.numel() * 4 for p in rend.net.parameters())
    assert got["mesh_bytes"] + got["bvh_bytes"] == sum(
        got[n]["total_bytes"] for n in ("original_mesh", "inner_shell",
                                        "outer_shell", "additional_mesh"))


def test_neural_lambert_through_the_renderer(tmp_path):
    (rend, pos), _ = _renderers(tiny_config(tmp_path))
    rend.set_use_neural_query(True)
    rend.set_lambert_view(True)
    img = rend.render(pos)
    assert rend.accum_sample_count == 0 and img.std() > 1.0
    rend.set_use_neural_query(False)
    assert (rend.render(pos) != img).any()
    with pytest.raises(ValueError, match="Lambert"):
        rend.render_accumulate(pos, 2)


@pytest.mark.parametrize("neural", [False, True])
def test_render_accumulate_chunking(tmp_path, neural):
    (rend, pos), _ = _renderers(tiny_config(tmp_path))
    rend.set_use_neural_query(neural)
    images, calls = [], []
    for chunk in (1, 64, 2):
        seen = []
        images.append(rend.render_accumulate(
            pos, 5, batch_spp=1, chunk_batches=chunk,
            progress=lambda done, total, seen=seen: seen.append(
                (done, total))))
        calls.append(seen)
    for img in images[1:]:
        np.testing.assert_array_equal(img, images[0])
    assert calls == [[(i, 5) for i in range(1, 6)], [(5, 5)],
                     [(2, 5), (4, 5), (5, 5)]]


def _evaluate(cfg, out, *extra):
    return evaluate.main([cfg, "--width", str(W), "--height", str(H),
                          "--device", "cpu", "--output", str(out), *extra])


def test_evaluate_host_loop_and_uneven_samples(tmp_path, capsys):
    """--host-loop writes the chunked path's images; 3 samples in batches
    of 2 (the last batch 1) render, equal to 3 batches of 1."""
    cfg = tiny_config(tmp_path)
    for name, extra in (("chunked", ["--chunk-batches", "1"]),
                        ("host", ["--host-loop"])):
        assert _evaluate(cfg, tmp_path / name, "--total-samples", "3",
                         "--batch-spp", "1", *extra) == 0
    assert _evaluate(cfg, tmp_path / "uneven", "--total-samples", "3",
                     "--batch-spp", "2") == 0
    out = capsys.readouterr().out
    assert "3/3" in out and "2/2" in out
    for image in ("ground_truth.png", "neural.png"):
        want = load_image(str(tmp_path / "chunked" / image))
        for name in ("host", "uneven"):
            np.testing.assert_array_equal(
                load_image(str(tmp_path / name / image)), want)


def test_evaluate_profile_and_dp(tmp_path, capsys):
    cfg = tiny_config(tmp_path)
    assert _evaluate(cfg, tmp_path / "out", "--total-samples", "1",
                     "--batch-spp", "1", "--profile") == 0
    out = capsys.readouterr().out
    assert out.count("ns/ray") == 2 and out.count("frame total") == 2
    tables = re.findall(r"category\s+ms\s+ns/ray\n(.*?)rays/frame", out,
                        re.S)
    assert len(tables) == 2
    assert "primaryTrace" in tables[0] and "bounceTrace" in tables[0]
    assert "shellTrace" in tables[1] and "neuralForward" in tables[1]
    assert "avg neural calls/ray" in out
    assert _evaluate(cfg, tmp_path / "dp", "--dp", "0") == 1
    assert "multi-GPU" in capsys.readouterr().err
