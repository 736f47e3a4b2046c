"""K10, the bounce sampler (csrc/sample_bounce.cu, ops/sample_bounce.py).

On the CPU: the stage runs its PyTorch twin and launches nothing; the
operands the kernel reads are packed at the offsets its source defines;
its bound in ops/bounds.py; the wrapper's contract; chip_smoke.py's hold
against planted faults. On a GPU (`@pytest.mark.cuda`, skipped without
one; imports no JAX, so on the card run it as
`python -m pytest --noconftest tests/test_torch_sample_bounce.py`): the
kernel against the twin on the card at chip_smoke.py's K10_* bounds (the
ROADMAP's "Bounce-sampler PDFs near GTR peaks": libm calls may round
otherwise, and an ulp of n.h moves a GTR pdf about a thousandfold more),
on the view's 4K first bounce, the knot's 1080p x 8 second bounce and
hand-made rows; its launch and ray counts, and no host sync inside the
stage.
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from neural_renderer_tpu_torch.ops import bounds
from neural_renderer_tpu_torch.ops import sample_bounce as k10
from neural_renderer_tpu_torch.render import pathtrace as pt
from neural_renderer_tpu_torch.render.params import RenderParams
from neural_renderer_tpu_torch.scene import materials
from neural_renderer_tpu_torch.scene.materials import Material
from neural_renderer_tpu_torch.utils import spans

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "neural_renderer_tpu_torch", "csrc",
                      "sample_bounce.cu")

# Hand-made rows: the global material of each case (the per-ray metallic,
# roughness and specular are drawn).
MATERIALS = {
    "default": {},
    "anisotropic": dict(anisotropy=0.6, specular_tint=0.4),
    "clearcoat": dict(clearcoat=0.8, clearcoat_gloss=0.3, sheen=0.5,
                      sheen_tint=0.7),
    "transmission": dict(specular_transmission=0.5, ior=1.45),
    "opaque_transmission": dict(specular_transmission=1.0),
}


def _rows(device, material="default", first=True, seed=0, width=40,
          height=25, offset=2**32 - 3):
    """Sampler inputs of width x height rays (1,000 by default: not a
    multiple of the kernel's 256-thread blocks) with sample offset
    `offset`: random normals with zero and NaN ones among them, random
    albedo (black on every 17th ray), metallic, roughness and specular;
    a fifth of the rays miss, a tenth of the hits are inactive."""
    params = RenderParams.make(
        width=width, height=height, samples_per_pixel=1, max_bounces=3,
        cam_pos=[0.0, 0.0, 3.0], cam_forward=[0.0, 0.0, -1.0],
        cam_right=[1.0, 0.0, 0.0], cam_up=[0.0, 1.0, 0.0], fov_y=0.9,
        material=Material.default().replace(**MATERIALS[material]),
        sample_offset=offset, scene_scale=2.0, device=device)
    pix, samp, _, _, _ = pt.primary_rays(params)
    n = pix.shape[0]
    r = np.random.default_rng(seed)
    normal = r.normal(size=(3, n)).astype(np.float32)
    normal[:, 5:9] = 0.0
    normal[1, 9:13] = np.nan
    albedo = r.uniform(size=(3, n)).astype(np.float32)
    albedo[:, ::17] = 0.0
    mp = np.stack([r.uniform(size=n), r.uniform(0.02, 1.0, size=n),
                   r.uniform(size=n)]).astype(np.float32)
    hit = r.uniform(size=n) < 0.8
    active = hit & (r.uniform(size=n) < 0.9)
    inc = r.normal(size=(3, n))
    inc = (inc / np.linalg.norm(inc, axis=0)).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    hits = pt.HitState(position=t(r.normal(size=(3, n)).astype(np.float32)),
                       normal=t(normal), albedo=t(albedo),
                       material_params=t(mp), hit=t(hit),
                       distance=t(r.uniform(size=n).astype(np.float32)))
    return params, pix, samp, hits, t(active), None if first else t(inc)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


# ---- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("first", [True, False])
def test_cpu_stage_runs_the_twin(first):
    """CPU tensors take the twin, which launches nothing; the stage's
    active flags are the paths whose sample is valid."""
    args = _rows("cpu", "clearcoat", first)
    before = k10.sample_bounce.launches
    rays, active = pt.sample_bounce(*args)
    assert k10.sample_bounce.launches == before == 0
    twin_rays, twin_active = pt.sample_bounce_twin(*args)
    for a, b in zip(rays, twin_rays):
        assert torch.equal(a, b)
    assert torch.equal(active, twin_active)
    hits, path_active = args[3], args[4]
    assert torch.equal(active, path_active & hits.hit & (rays.pdf > 0))
    assert rays.distance is hits.distance
    assert 0.3 < active.float().mean().item() < 0.9
    assert torch.equal(pt.sample_bounce_directions(*args).pdf, rays.pdf)


def test_pack_operands_layout():
    """pack_operands writes the camera basis, fov_y, scene_scale and the
    material row at the offsets csrc/sample_bounce.cu reads, and the
    source's material offsets are scene/materials.py's."""
    params = _rows("cpu", "anisotropic")[0]
    ops = k10.pack_operands(params)
    assert ops.dtype == torch.float32 and ops.shape == (29,)
    for at, want in ((k10.FORWARD, params.cam_forward),
                     (k10.RIGHT, params.cam_right), (k10.UP, params.cam_up),
                     (k10.FOV_Y, params.fov_y.reshape(1)),
                     (k10.SCENE_SCALE, params.scene_scale.reshape(1)),
                     (k10.MATERIAL, params.material_row)):
        assert torch.equal(ops[at:at + want.numel()], want)
    src = open(SOURCE).read()
    defines = dict(re.findall(r"#define (SB_\w+) (\d+|\(SB_MATERIAL \+ \d+\))",
                              src))
    for name in ("FORWARD", "RIGHT", "UP", "FOV_Y", "SCENE_SCALE",
                 "MATERIAL"):
        assert int(defines["SB_" + name]) == getattr(k10, name), name
    for name in ("SPECULAR_TINT", "ANISOTROPY", "SHEEN", "SHEEN_TINT",
                 "CLEARCOAT", "CLEARCOAT_GLOSS", "IOR", "SPEC_TRANS"):
        offset = int(re.search(r"\d+", defines["SB_P_" + name]).group())
        assert offset == getattr(materials, "P_" + name), name
    assert re.search(r"#define SB_OPERANDS \(SB_MATERIAL \+ (\d+)\)",
                     src).group(1) == str(materials.NUM_SCALARS)
    assert ops.numel() == k10.MATERIAL + materials.NUM_SCALARS


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The launch takes CUDA tensors of the documented shapes and types
    only, and says so before it builds or launches anything."""
    params, pix, samp, hits, active, _ = _rows("cpu", first=False)
    rows = (hits.position, hits.normal, hits.albedo, hits.material_params)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        k10.sample_bounce(params, pix, samp, *rows, hits.hit, active)
    with pytest.raises(ValueError, match=r"incoming must be \[3, 1000\]"):
        k10.sample_bounce(params, pix, samp, *rows, hits.hit, active,
                          incoming=hits.normal[:, :10])
    with pytest.raises(ValueError, match=r"path_active must be \[1000\]"):
        k10.sample_bounce(params, pix, samp, *rows, hits.hit, active[:-1])
    assert k10.sample_bounce.launches == 0


@pytest.mark.parametrize("first", [True, False])
def test_sample_bounce_bound(first):
    """bounds.sample_bounce_seconds: the larger of the call's bytes at
    3.35e12 B/s and its operations at the FP32 instruction rate. The bytes
    are those of the operands a call reads and writes: every ray's flags
    and outputs, a live ray's ids, rows and (after the first bounce) its
    incoming direction. The view's 4K first bounce is bound by bytes."""
    args = _rows("cpu", first=first)
    hits, path_active, inc = args[3], args[4], args[5]
    rays, active = pt.sample_bounce(*args)
    n = hits.hit.numel()
    per_ray = sum(t.element_size() * t.numel() for t in (
        hits.hit, path_active, rays.origin, rays.direction, rays.pdf,
        rays.brdf_weight, active)) // n
    per_live = sum(t.element_size() * t.numel() for t in (
        args[1], args[2], hits.position, hits.normal, hits.albedo,
        hits.material_params, *(() if first else (inc,)))) // n
    assert per_ray == bounds.SAMPLE_RAY_BYTES == 43
    assert per_live == bounds.SAMPLE_LIVE_BYTES + (
        0 if first else bounds.SAMPLE_INCOMING_BYTES)
    live = int((hits.hit & path_active).sum())
    nbytes, ops = bounds.sample_bounce_work(n, live, first)
    assert nbytes == n * per_ray + live * per_live
    assert ops == live * (bounds.SAMPLE_OPS
                          + (bounds.SAMPLE_CAMERA_OPS if first else 0))
    assert bounds.sample_bounce_seconds(n, live, first) == max(
        nbytes / 3.35e12, ops / (132 * 128 * 1.98e9))
    view = 3840 * 2160
    t_bytes, t_ops = bounds.sample_bounce_work(view, view // 3, True)
    assert t_bytes / bounds.BYTES_RATE > t_ops / bounds.FP32_RATE
    assert 0.1e-3 < bounds.sample_bounce_seconds(view, view // 3, True) \
        < 0.4e-3


def test_k10_hold_rejects_planted_faults():
    """chip_smoke.py's hold of K10 (k10_errors, k10_faults) passes the
    twin against itself and rejects each fault k10_planted plants."""
    args = _rows("cpu", "clearcoat", first=False, width=64, height=48)
    rays, active = pt.sample_bounce_twin(*args)
    e = chip_smoke.k10_errors((rays, active), (rays, active))
    assert chip_smoke.k10_faults(e) == "", e
    assert e["rays"] == 64 * 48
    for label, bad in chip_smoke.k10_planted(rays, active).items():
        assert chip_smoke.k10_faults(
            chip_smoke.k10_errors(bad, (rays, active))), label


# ---- on the card ------------------------------------------------------------

def _hold(args):
    """Run the stage (K10) and its twin on `args`, hold them to
    chip_smoke's K10_* bounds; the stage must launch K10 once and count
    its rays."""
    n = args[1].numel()
    before = k10.sample_bounce.launches
    spans.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with spans.span("sampleBounce"):
            got = pt.sample_bounce(*args)
    totals = spans.totals()
    assert k10.sample_bounce.launches == before + 1
    assert totals["counts"] == {"sample_kernel_rays": n}
    assert not [s for s in totals["spans"] if s.startswith("sync.")]
    assert got[0].distance is args[3].distance
    want = pt.sample_bounce_twin(*args)
    e = chip_smoke.k10_errors(got, want)
    print(e)
    assert chip_smoke.k10_faults(e) == "", e
    assert got[1].any()
    return e


@pytest.mark.cuda
def test_k10_view_first_bounce_4k(cuda):
    """The lane sphere's view at 3840x2160 x 1: the first bounce, the
    camera ray regenerated from the RNG stream."""
    rend, pos = chip_smoke.sampler_renderer("sphere/sphere_lane.json", 3840,
                                            2160, 1)
    args = chip_smoke.sampler_inputs(lambda: rend.render(pos), [0])[0]
    assert args[5] is None and args[1].numel() == 3840 * 2160
    handed, counted = chip_smoke.sampler_rays_traced(
        lambda: rend.render(pos))
    assert counted == handed >= 3840 * 2160
    _hold(args)


@pytest.mark.cuda
def test_k10_knot_second_bounce(cuda):
    """The knot's evaluate batch at 1920x1080 x 8: the second bounce, the
    stored incoming directions."""
    rend, pos = chip_smoke.sampler_renderer("knot/knot_lane.json", 1920,
                                            1080, 8)
    args = chip_smoke.sampler_inputs(
        lambda: rend.render_accumulate(pos, 8, batch_spp=8), [1])[0]
    assert args[5] is not None and args[1].numel() == 1920 * 1080 * 8
    handed, counted = chip_smoke.sampler_rays_traced(
        lambda: rend.render_accumulate(pos, 8, batch_spp=8))
    assert counted == handed >= 2 * 1920 * 1080 * 8
    _hold(args)


@pytest.mark.cuda
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("material", sorted(MATERIALS))
def test_k10_hand_rows(cuda, material, first):
    """Hand-made rows: anisotropy, clearcoat and sheen, transmission below
    and at 1 (every sample invalid), zero and NaN normals, misses,
    inactive rays, a sample offset near 2^32, a ragged last block."""
    args = _rows(cuda, material, first, seed=len(material))
    if material == "opaque_transmission":
        rays, active = pt.sample_bounce(*args)
        assert not active.any() and not rays.pdf.any()
        assert not rays.direction.any() and not rays.brdf_weight.any()
        return
    e = _hold(args)
    assert e["rays"] == 1000


@pytest.mark.cuda
@pytest.mark.parametrize("first", [True, False])
def test_k10_strided_operands(cuda, first):
    """The wrapper makes strided operands contiguous itself: [3, N] rows
    that are views of [N, 3] storage give the contiguous call's result."""
    args = _rows(cuda, "default", first, seed=7)
    params, pix, samp, hits, active, inc = args

    def strided(x):
        return None if x is None else x.T.contiguous().T

    rows = ("position", "normal", "albedo", "material_params")
    shits = hits._replace(**{f: strided(getattr(hits, f)) for f in rows})
    assert not shits.position.is_contiguous()
    got = pt.sample_bounce(params, pix, samp, shits, active, strided(inc))
    want = pt.sample_bounce(*args)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1])
