"""Parity of the PyTorch port's foundation modules with the JAX package:
RNG, camera rays, environment lighting, sRGB, the bounce sampler, the
import-without-JAX rule and the exported trained weights. Inputs are made
with numpy from a seed and handed to both packages."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.ops import envlight as jenv
from neural_renderer_tpu.ops import rng as jrng
from neural_renderer_tpu.ops import srgb as jsrgb
from neural_renderer_tpu.render import pathtrace as jpt
from neural_renderer_tpu.render.params import RenderParams as JParams
from neural_renderer_tpu.scene.envmap import EnvironmentMap
from neural_renderer_tpu.scene.materials import Material as JMaterial

from neural_renderer_tpu_torch.ops import envlight, rng, srgb
from neural_renderer_tpu_torch.render import pathtrace as pt
from neural_renderer_tpu_torch.render.params import RenderParams
from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
from neural_renderer_tpu_torch.scene.materials import Material

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CAM = dict(cam_pos=[0.3, -0.2, 3.0], cam_forward=[0.0, 0.0, -1.0],
            cam_right=[1.0, 0.0, 0.0], cam_up=[0.0, 1.0, 0.0], fov_y=0.9,
            scene_scale=2.0)


def _params(w, h, spp, offset, material=(0.6, 0.3, 0.2)):
    rough, spec, metal = material
    jm = JMaterial.default()
    jm.roughness.value, jm.specular.value = rough, spec
    jm.metallic.value = metal
    jp = JParams.make(w, h, spp, 3, material=jm, sample_offset=offset,
                      **_CAM)
    tp = RenderParams.make(w, h, spp, 3, device="cpu", sample_offset=offset,
                           material=Material(roughness=rough, specular=spec,
                                             metallic=metal), **_CAM)
    return jp, tp


def _ulps(a, b):
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


def test_rng_streams_bit_exact():
    """init_rng + rand01 states and values equal the JAX stream exactly,
    including wrap-around of large pixel ids and offsets (tolerance 0)."""
    r = np.random.default_rng(3)
    pix = r.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    samp = r.integers(0, 64, 4096).astype(np.uint32)
    for offset in (0, 7, 2 ** 32 - 3):
        js = jrng.init_rng(jnp.asarray(pix), jnp.uint32(offset),
                           jnp.asarray(samp))
        ts = rng.init_rng(torch.as_tensor(pix.astype(np.int64)), offset,
                          torch.as_tensor(samp.astype(np.int64)))
        for _ in range(3):
            js, jv = jrng.rand01(js)
            ts, tv = rng.rand01(ts)
            np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                          np.asarray(js))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_primary_rays_within_2ulp():
    """Camera rays (jittered, spp 2, a sample offset) within 2 ulp."""
    jp, tp = _params(37, 23, 2, 5)
    jpix, js, _, jo, jd = jpt.primary_rays(jp)
    tpix, ts, _, to, td = pt.primary_rays(tp)
    np.testing.assert_array_equal(tpix.numpy(), np.asarray(jpix))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert _ulps(td.numpy(), np.asarray(jd)).max() <= 2


@pytest.mark.parametrize("valid", [False, True])
def test_sample_environment(valid):
    """Sky fallback and a rotated, scaled equirect map, to f32 rounding
    (atan2/acos/floor run in each library's own f32 code: rtol 1e-5)."""
    r = np.random.default_rng(4)
    d = r.normal(size=(3, 500)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    pixels = r.uniform(0, 3, size=(8, 16, 3)).astype(np.float32)
    pixels[2, 3] = 250.0  # above the hard clamp
    if valid:
        em = EnvironmentMap()
        em.pixels, em.rotation, em.strength = pixels, 30.0, 1.7
        jenvs = em.to_arrays()
        tenv = EnvironmentTensors.from_numpy(pixels, rotation=30.0,
                                             strength=1.7, device="cpu")
    else:
        jenvs = EnvironmentMap().to_arrays()
        tenv = EnvironmentTensors.from_numpy(None, device="cpu")
    ref = np.asarray(jenv.sample_environment_clamped(jenvs, jnp.asarray(d),
                                                     50.0))
    out = envlight.sample_environment_clamped(tenv, torch.as_tensor(d),
                                              50.0).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_encode_srgb_u8():
    """Linear -> sRGB to f32 rounding; the truncating u8 cast may differ by
    one step where pow lands on either side of a boundary."""
    c = np.random.default_rng(5).uniform(-0.2, 1.5, (3, 20000)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        srgb.linear_to_srgb(torch.as_tensor(c)).numpy(),
        np.asarray(jsrgb.linear_to_srgb(jnp.asarray(c))), rtol=2e-6,
        atol=1e-7)
    a = srgb.encode_srgb_u8(torch.as_tensor(c)).numpy().astype(int)
    b = np.asarray(jsrgb.encode_srgb_u8(jnp.asarray(c))).astype(int)
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() < 1e-3


@pytest.mark.parametrize("first_bounce", [True, False])
def test_sample_bounce_directions(first_bounce):
    """Disney 3-component sampling + BRDF weight of random hits against the
    JAX sampler: the same RNG draws; directions to 1e-4 relative
    (sin/cos/pow/log differ by ulps between libraries), PDFs and weights to
    1e-2 (below); validity equal but for rays at the lobe boundaries."""
    jp, tp = _params(16, 12, 1, 3)
    n = 16 * 12
    r = np.random.default_rng(6)
    normal = r.normal(size=(3, n)).astype(np.float32)
    pos = r.normal(size=(3, n)).astype(np.float32)
    albedo = r.uniform(size=(3, n)).astype(np.float32)
    mp = np.stack([np.full(n, 0.2), np.full(n, 0.6), np.full(n, 0.3)]) \
        .astype(np.float32)
    hit = r.uniform(size=n) < 0.8
    inc = r.normal(size=(3, n)).astype(np.float32)
    inc /= np.linalg.norm(inc, axis=0, keepdims=True)
    dist = r.uniform(size=n).astype(np.float32)
    jh = jpt.HitState(*(jnp.asarray(x) for x in
                        (pos, normal, albedo, mp, hit, dist)))
    th = pt.HitState(*(torch.as_tensor(x) for x in
                       (pos, normal, albedo, mp, hit, dist)))
    jpix, js, _, _, _ = jpt.primary_rays(jp)
    tpix, ts, _, _, _ = pt.primary_rays(tp)
    jr = jpt.sample_bounce_directions(
        jp, jpix, js, jh, jnp.asarray(hit),
        None if first_bounce else jnp.asarray(inc))
    tr = pt.sample_bounce_directions(
        tp, tpix, ts, th, torch.as_tensor(hit),
        None if first_bounce else torch.as_tensor(inc))
    jvalid = np.asarray(jr.pdf) > 0
    tvalid = tr.pdf.numpy() > 0
    assert (jvalid != tvalid).mean() < 0.02
    both = jvalid & tvalid
    # Directions to 1e-4. The GTR lobes' PDFs divide by (1 + (a2-1) n.h^2)^2,
    # which near a lobe peak magnifies an ulp of n.h about a thousandfold:
    # PDFs and BRDF weights to 1e-2.
    for a, b, rtol in ((tr.direction, jr.direction, 1e-4),
                       (tr.origin, jr.origin, 1e-4),
                       (tr.pdf, jr.pdf, 1e-2),
                       (tr.brdf_weight, jr.brdf_weight, 1e-2)):
        a, b = a.numpy()[..., both], np.asarray(b)[..., both]
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-5)
        print(f"max relative difference {rel.max():.3g} (tolerance {rtol})")
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5)


def test_import_without_jax():
    """The port imports with JAX, the JAX package, imageio, matplotlib,
    orbax and optax made unimportable (sys.modules[name] = None), every
    module of the package included (train, cli.train, ops.fused_network,
    ops.trace_mxu and the environment and EXR modules among them); then,
    still without them, it loads the studio scene (the PIZ EXR sky, the
    glTF torus and its PNG textures)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'neural_renderer_tpu', 'imageio', 'matplotlib',"
        " 'orbax', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import neural_renderer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, p.__name__ + '.')]\n"
        "assert {p.__name__ + '.' + m for m in ('train', 'cli.train', "
        "'ops.fused_network', 'ops.trace_mxu', 'scene.envmap', 'scene.exr', "
        "'scene.exr_piz', 'scene.exr_b44', 'scene.exr_write')}"
        " <= set(names)\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from neural_renderer_tpu_torch.config import load_config\n"
        "from neural_renderer_tpu_torch.scene.scene import Scene\n"
        "s = Scene.from_config(load_config("
        "'configs/studio/studio_lane.json'))\n"
        "assert s.environment.is_valid and len(s.original_mesh.textures) == 2"
        "\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_trained_weights_npz_matches_orbax_restore():
    """configs/sphere/lane16_step24000.npz (written by
    scripts/export_lane_ckpt_npz.py) equals the orbax restore exactly."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import export_lane_ckpt_npz as exp
    finally:
        sys.path.pop(0)
    from neural_renderer_tpu_torch.models import convert, nbvh
    ref = exp.restore_params(exp.DEFAULT_CKPT)
    got = convert.load_params_npz(exp.DEFAULT_OUT)
    np.testing.assert_array_equal(got["lane"], ref["lane"])
    assert len(got["mlp"]) == len(ref["mlp"]) == 5
    for a, b in zip(got["mlp"], ref["mlp"]):
        np.testing.assert_array_equal(a, b)
    net = convert.params_from_numpy(
        got, nbvh.NbvhConfig(lane_sublanes=16, lane_entry_pack=2),
        device="cpu")
    assert tuple(net.lane.shape) == (3, 8, 4, 16, 2, 128)
