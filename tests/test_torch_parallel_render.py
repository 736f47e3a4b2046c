"""The port's pixel-stripe rendering, tiled denoiser and psnr_tiled, on the
CPU.

Four ranks over gloo are spawned once for the module
(tests/torch_parallel_checks.py::render_checks, joined within 120 s) and
every tiled result is held to the single-process one EXACTLY
(`torch.equal`): two accumulation batches of the ground-truth and the
neural 32x24 frame (2 bounces, 4 stripes of 6 rows), the second with its
guide buffers; the tiled denoiser on that accumulation; psnr_tiled
(float64 sums, to 1e-12 relative, as only their order differs). Stripes
rendered in one process and stitched equal the whole frame exactly. A
port stripe (`row0` / `n_rows`) against the JAX package's stripe, the JAX
side under `jax.disable_jit()`, at tests/test_torch_frame.py's tolerance
(max u8 difference 2, under 5% of pixels differ). psnr_tiled against the
JAX package's on the conftest's virtual CPU devices, on the same 32x24
images, to 1e-6 relative (JAX sums in float32 without x64). The
Renderer's three fallback reasons: each frame counted, each reason warned
once. `evaluate --dp 2 --device cpu` writes the PNGs of `--dp 1`, byte
for byte. The port's dry run (`parallel/dryrun.py`, the counterpart of
`__graft_entry__.dryrun_multichip`) passes on four ranks.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.parallel import make_mesh as jmake_mesh
from neural_renderer_tpu.parallel import psnr_tiled as jpsnr_tiled
from neural_renderer_tpu.render import pathtrace as jpt
from neural_renderer_tpu.render.neural_frame import \
    render_neural_frame as jframe
from neural_renderer_tpu.render.neural_march import NeuralContext as JCtx
from neural_renderer_tpu.render.params import RenderParams as JParams
from neural_renderer_tpu.scene.envmap import EnvironmentMap
from neural_renderer_tpu.scene.materials import Material as JMaterial
from neural_renderer_tpu.scene.mesh import Mesh

import torch_parallel_checks as checks
from torch_scenes import tiny_config
from util import outward_sphere

from neural_renderer_tpu_torch.cli import evaluate
from neural_renderer_tpu_torch.metrics import compute_psnr, load_image
from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.ops.denoise import bilateral_denoise
from neural_renderer_tpu_torch.parallel.dryrun import dryrun_multichip
from neural_renderer_tpu_torch.parallel.launch import spawn
from neural_renderer_tpu_torch.render import neural_frame
from neural_renderer_tpu_torch.render import pathtrace as pt
from neural_renderer_tpu_torch.render.neural_march import NeuralContext

torch.set_num_threads(1)

W, H = checks.W, checks.H


@pytest.fixture(scope="module")
def ranks():
    return spawn(checks.render_checks, 4, "cpu", join_timeout=120,
                 threads=1)


@pytest.fixture(scope="module")
def scene():
    return checks.render_scene()


def _frames(scene, stripes=1):
    """Both batches of both frames in one process, each stripe with its
    own accumulation rows, stitched."""
    ctx, gt, env, params = scene
    rows = H // stripes
    fns = {"gt": lambda p, acc, g, r0: pt.render_gt_frame(
               gt, env, p, acc, return_guides=g, row0=r0, n_rows=rows),
           "neural": lambda p, acc, g, r0: neural_frame.render_neural_frame(
               ctx, env, p, acc, return_guides=g, row0=r0, n_rows=rows)}
    out = {}
    for name, fn in fns.items():
        parts = []
        for i in range(stripes):
            img0, acc = fn(params(0), torch.zeros((3, W * rows)), False,
                           i * rows)
            img, acc, guides = fn(params(1), acc, True, i * rows)
            parts.append((img0, img, acc.reshape(3, rows, W), guides))
        out[name] = dict(
            img0=torch.cat([p[0] for p in parts]),
            img=torch.cat([p[1] for p in parts]),
            acc=torch.cat([p[2] for p in parts], dim=1).reshape(3, -1),
            guides=tuple(torch.cat([p[3][k] for p in parts], dim=1)
                         for k in (0, 1)))
    return out


@pytest.fixture(scope="module")
def whole(scene):
    return _frames(scene)


@pytest.mark.parametrize("name", ["gt", "neural"])
def test_stripes_stitch_to_whole_frame(scene, whole, name):
    """Four stripes rendered one by one (global pixel ids, each with its
    accumulation rows) stitch to the whole frame bit for bit: both
    batches' images, the accumulation and the guides."""
    got = _frames(scene, stripes=4)[name]
    want = whole[name]
    for key in ("img0", "img", "acc"):
        assert torch.equal(got[key], want[key]), key
    for a, b in zip(got["guides"], want["guides"]):
        assert torch.equal(a, b)
    assert want["img"].float().std() > 5.0


@pytest.mark.parametrize("name", ["gt", "neural"])
def test_tiled_frames_equal_single_process(ranks, whole, name):
    """The four ranks' gathered images equal the single-process frames
    exactly on every rank; their accumulation and guide stripes (each
    rank keeps its own rows) stitch to the whole frame's."""
    want = whole[name]
    for r in ranks:
        for key in ("img0", "img"):
            assert torch.equal(r[name][key], want[key]), key
        assert r[name]["acc"].shape == (3, W * H // len(ranks))
    acc = torch.cat([r[name]["acc"].reshape(3, -1, W) for r in ranks], 1)
    assert torch.equal(acc.reshape(3, -1), want["acc"])
    for k in (0, 1):
        stitched = torch.cat([r[name]["guides"][k] for r in ranks], dim=1)
        assert torch.equal(stitched, want["guides"][k])


def test_tiled_denoise_equals_whole(ranks, whole):
    """bilateral_denoise_tiled (halos over batch_isend_irecv, each rank's
    accumulation stripe) equals bilateral_denoise of the whole frame
    exactly on every rank."""
    acc = whole["neural"]["acc"].reshape(3, H, W)
    want = bilateral_denoise(acc, 2, *whole["neural"]["guides"])
    for r in ranks:
        assert torch.equal(r["denoised"], want)
    assert not torch.equal(want, whole["neural"]["img"])


def test_tiled_renderer_equals_single_process(ranks):
    """The Renderer with a 4-rank mesh: plain, denoised and
    render_accumulate frames equal one process's exactly on every rank,
    no frame falls back, and each rank's accumulation is its quarter of
    the pixels (only the u8 image is gathered)."""
    want = checks.renderer_frames()
    for r in ranks:
        got = r["renderer"]
        assert got["fallback"] == 0
        for (img, n), (wimg, wn) in zip(got["frames"], want["frames"]):
            assert np.array_equal(img, wimg)
            assert n * 4 == wn == 16 * 24
    assert not np.array_equal(want["frames"][1][0], want["frames"][2][0])


def test_psnr_tiled_matches_single_process_and_jax(ranks, whole,
                                                   cpu_devices):
    """psnr_tiled over the four ranks against compute_psnr, 1e-12
    relative (float64 sums in another order), and against the JAX
    package's psnr_tiled on four virtual CPU devices, 1e-6 relative: JAX
    truncates its float64 to float32 without jax_enable_x64, the suite's
    setting."""
    ref = whole["gt"]["img"].numpy()
    test = whole["neural"]["img"].numpy()
    want = compute_psnr(ref, test)
    mesh = jmake_mesh(cpu_devices[:4], dp=4, tp=1)
    jgot = float(jpsnr_tiled(jnp.asarray(ref), jnp.asarray(test), mesh))
    for r in ranks:
        assert abs(r["psnr"] - want) <= 1e-12 * want
        assert abs(r["psnr"] - jgot) <= 1e-6 * jgot
    assert 5.0 < want < 100.0


def test_fallback_reasons_counted(ranks):
    """Two Lambert frames, a height of 18 on 4 stripes and a denoised
    frame of 4-row stripes fall back and are counted, each reason warned
    once; the next plain frame runs in stripes. memory_stats reports the
    backend."""
    fb = ranks[0]["fallback"]
    assert fb["counts"] == [1, 2, 3, 4, 4]
    assert len(fb["warnings"]) == 3
    for reason in ("Lambert", "height 18", "stencil radius"):
        assert sum(reason in w for w in fb["warnings"]) == 1
    assert fb["stats"]["backend"] == "gloo"
    assert fb["stats"]["ranks_per_gpu"] == 0


def test_evaluate_dp_cpu(tmp_path):
    """evaluate --dp 2 --device cpu writes the PNGs of --dp 1, byte for
    byte."""
    cfg = tiny_config(tmp_path)
    common = [cfg, "--width", "24", "--height", "16", "--total-samples",
              "2", "--batch-spp", "1", "--device", "cpu"]
    assert evaluate.main(common + ["--output", str(tmp_path / "a")]) == 0
    assert evaluate.main(common + ["--output", str(tmp_path / "b"),
                                   "--dp", "2"]) == 0
    for image in ("ground_truth.png", "neural.png", "flip_error.png"):
        with open(tmp_path / "a" / image, "rb") as f:
            a = f.read()
        with open(tmp_path / "b" / image, "rb") as f:
            assert f.read() == a, image
    assert load_image(str(tmp_path / "b" / "neural.png")).std() > 1.0
    assert os.path.exists(tmp_path / "b" / "flip_error.png")


def test_dryrun_multichip():
    """The port's dry run on four ranks: a dp2 x tp2 step and both stripe
    renders."""
    out = dryrun_multichip(4, join_timeout=120)
    assert (out["dp"], out["tp"]) == (2, 2)
    assert np.isfinite(out["loss"])
    assert out["gt"] == out["neural"] == (8, 16, 3)


# ---- a port stripe against the JAX stripe --------------------------------

def _carry(a):
    n = np.asarray
    return convert.mesh_from_numpy(
        n(a.tris_packed), a.num_triangles, device="cpu",
        vertices=n(a.vertices), normals=n(a.normals), uvs=n(a.uvs),
        indices=n(a.indices), tri_material=n(a.tri_material),
        nodes_packed=n(a.nodes_packed), mat_scalars=n(a.mat_scalars),
        has_normals=a.has_normals, has_uvs=a.has_uvs,
        has_materials=a.has_materials, max_leaf=a.max_leaf)


@pytest.fixture(scope="module")
def jax_scene():
    om, im, gm = (outward_sphere(24, 48, 1.2), outward_sphere(24, 48, 0.8),
                  outward_sphere(16, 32, 1.0))
    arrays = [m.to_arrays() for m in (om, im, gm)]
    jcfg = jnbvh.NbvhConfig(grid_type="lane", lane_sublanes=4)
    jp = jnbvh.init_params(jax.random.PRNGKey(0), jcfg)
    jp["lane"] = (jp["lane"] * 1e3).astype(jnp.bfloat16).astype(jnp.float32)
    omin, omax = om.bounds()
    return arrays, jcfg, jp, dict(outer_shell_min=omin,
                                  outer_shell_inv_extent=1.0 / (omax - omin))


@pytest.mark.parametrize("name", ["gt", "neural"])
def test_stripe_matches_jax(jax_scene, name):
    """Rows 6-11 of the 32x24 frame (1 bounce) through `row0` / `n_rows`
    in both packages: max u8 difference 2, under 5% of pixels differ."""
    (oa, ia, ga), jcfg, jp, bounds = jax_scene
    row0, rows = 6, 6
    jm = JMaterial.default()
    jm.roughness.value, jm.specular.value = 0.6, 0.3
    cam = {k: v for k, v in checks.CAM.items()}
    jparams = JParams.make(W, H, 1, 1, material=jm, **cam, **bounds)
    acc0 = jnp.zeros((3, W * rows), jnp.float32)
    with jax.disable_jit():
        if name == "gt":
            ref, _ = jpt.render_gt_frame(ga, EnvironmentMap().to_arrays(),
                                         jparams, acc0, row0=row0,
                                         n_rows=rows)
        else:
            ref, _ = jframe(JCtx(outer=oa, inner=ia, net_params=jp,
                                 config=jcfg), Mesh().to_arrays(),
                            EnvironmentMap().to_arrays(), jparams, acc0,
                            row0=row0, n_rows=rows)
    ref = np.asarray(ref)
    _, _, env, params = checks.render_scene()
    p = params(0, bounces=1)
    if name == "gt":
        img, _ = pt.render_gt_frame(_carry(ga), env, p,
                                    torch.zeros((3, W * rows)), row0=row0,
                                    n_rows=rows)
    else:
        net = convert.params_from_numpy(
            {"lane": np.asarray(jp["lane"]),
             "mlp": [np.asarray(w) for w in jp["mlp"]]},
            nbvh.NbvhConfig(lane_sublanes=4), device="cpu")
        ctx = NeuralContext(_carry(oa), _carry(ia), net)
        img, _ = neural_frame.render_neural_frame(
            ctx, env, p, torch.zeros((3, W * rows)), row0=row0, n_rows=rows)
    assert img.shape == ref.shape == (rows, W, 3)
    diff = np.abs(img.numpy().astype(int) - ref.astype(int))
    assert diff.max() <= 2
    assert (diff.sum(axis=-1) > 0).mean() < 0.05
    assert ref.std() > 1.0
