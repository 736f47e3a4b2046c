"""The prefilter rules of the trace-kernel ablation's redesigned kernels, on
the CPU.

The sweep variants (csrc/ablate_sweep.cu: `nodiv`, `recip`, `recipx`,
`bf16` on K4's walk) and the bf16 matrix form (csrc/ablate_mxu_bf16.cu:
`mxu_hi3`, `mxu_lo`) run the rest of their pair math only on the pairs
their prefilter leaves. `trace_ablation.variant_rule` is each sweep
variant's rule on its own det, u·det and v·det (`variant_prefilter` on the
twin's values), `trace_ablation.mxu_bf16_rule` the matrix form's on its f32
accumulators. A pair a rule rejects must be one that the variant's twin
rejects too (`variant_pairs`, `trace_mxu_bf16_twin`, held to the JAX
variants by tests/test_torch_ablate_trace.py; the kernels to the twins on
the card by tests/test_torch_cuda.py): held here on ray/triangle pairs of a
sphere, on numerators placed at each rule's margins (for `recipx` with the
reciprocal moved by up to 16 ulps or flushed to zero, as the card's
rcp.approx.ftz.f32 may give it; for `bf16` on bf16 values beside the
bounds and the rounding edges of 1), and by the prefiltered twins, the
kernels' walks on the CPU, which must equal the unfiltered ones row for
row.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from neural_renderer_tpu_torch.ops import trace_ablation, trace_mxu, \
    trace_pallas
from neural_renderer_tpu_torch.ops.trace_pallas import MISS, TRI_EPSILON
from neural_renderer_tpu_torch.scene.mesh import outward_sphere

torch.set_num_threads(1)

VARIANTS = trace_ablation.SWEEP_VARIANTS


def _rays(n, seed, inside=0.25):
    """n rays from radius 3 at random targets, a share from inside the
    shell; [3, n] f32."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(3, n))
    o = 3.0 * o / np.linalg.norm(o, axis=0)
    k = int(n * inside)
    o[:, :k] *= r.uniform(0.0, 0.35, k)
    d = r.uniform(-1.3, 1.3, size=(3, n)) - o
    d /= np.linalg.norm(d, axis=0)
    return tuple(torch.as_tensor(x, dtype=torch.float32) for x in (o, d))


def _shell():
    return outward_sphere(24, 48, 1.15).to_tensors("cpu").tris_packed


@pytest.mark.parametrize("variant", VARIANTS)
def test_rule_rejects_only_pairs_the_twin_rejects(variant):
    """On 1,000 rays x 2,304 triangles no pair the variant's rule rejects
    is kept by its twin (`variant_pairs`), the v test keeps a subset of
    the u test, and together they leave few pairs a ray."""
    o, d = _rays(1000, seed=3)
    tb = _shell()
    t, _ = trace_ablation.variant_pairs(variant)(o, d, tb)
    hit = t.float() < MISS
    face, keep_u, keep_v = trace_ablation.variant_prefilter(
        o[:, :, None], d[:, :, None], tb[:, None, :], variant)
    assert int(hit.sum()) > 400
    assert bool(face.all())
    assert not bool((hit & ~keep_v).any())
    assert not bool((keep_v & ~keep_u).any())
    assert keep_u.double().mean().item() < 0.2
    assert keep_v.double().mean().item() < 0.01


def test_recip_rule_is_the_dense_rule():
    """`recip` takes the value of 1.0f / det, so its rule is K4's."""
    r = np.random.default_rng(7)
    det, u, v = (torch.as_tensor(r.normal(size=(64, 64)), dtype=torch.float32)
                 for _ in range(3))
    for a, b in zip(trace_ablation.variant_rule("recip", det, u, v),
                    trace_pallas.dense_rule(det, u, v)):
        assert torch.equal(a, b)


def _f32(x):
    return np.float32(x)


def _to_bf16(x):
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


def _bf16_steps(x, k):
    """bf16 values k steps (ulps) from each bf16 value of x, toward +inf for
    positive k on positive x."""
    bits = x.view(torch.int16).to(torch.int32) + k
    return bits.to(torch.int16).view(torch.bfloat16)


def _margin_values(variant):
    """Determinants at the twins' thresholds and numerators placed against
    them: at |det|, at the rule's bounds and the values beside them, at
    wider factors, and absolute values tiny enough that num / det rounds to
    -0.0. For `bf16`, everything rounded to bf16, with the bf16 values up
    to 4 steps from each (which covers the rounding edges of u and v at 0
    and 1)."""
    up, down = np.inf, -np.inf
    eps = _f32(TRI_EPSILON)
    top = _f32(2.0 ** 126)
    mags = [np.nextafter(eps, _f32(0)), eps, np.nextafter(eps, _f32(1)),
            _f32(1e-3), _f32(0.7), _f32(1.0), _f32(3.0), _f32(2.0 ** 40),
            _f32(2.0 ** 100), np.nextafter(top, _f32(0)), top,
            _f32(2.0 ** 127), _f32(3.0e38)]
    if variant == "bf16":
        # The bf16 values at and beside each (bf16's 1e-8 among them).
        b = _to_bf16(mags)
        mags = [_f32(x) for k in (-1, 0, 1)
                for x in _bf16_steps(b, k).float().tolist()]
    dets = [s * m for s in (1.0, -1.0) for m in mags]
    dets += [_f32(0.0), _f32(-0.0), _f32(1e-45), _f32(up), _f32(down),
             _f32(np.nan)]
    lo_f, hi_f = trace_ablation.RULE_MARGINS.get(variant, (0.0, 1.0))
    rel = []
    with np.errstate(over="ignore", invalid="ignore"):
        for a in (abs(x) for x in dets):
            near = [a, np.nextafter(a, _f32(down)), np.nextafter(a, _f32(up))]
            for bound in (_f32(a * _f32(hi_f)), _f32(a * _f32(lo_f))):
                near += [bound, np.nextafter(bound, _f32(down)),
                         np.nextafter(bound, _f32(up))]
            near += [_f32(a * f) for f in (0.0, 2.0 ** -23, 2.0 ** -21, 0.3,
                                           0.5, 1 + 2.0 ** -21, 1 + 2.0 ** -8,
                                           1 + 2.0 ** -6, 2.0, 1e30)]
            rel.append(near)
    absolute = [_f32(2.0 ** -100), _f32(2.0 ** -60), _f32(2.0 ** -112),
                _f32(2.0 ** -133), _f32(2.0 ** -140), _f32(1e-45),
                _f32(0.0)]
    return dets, rel, absolute


def _numerators(variant, near, absolute):
    """The numerators of one determinant, with either sign: f32, or bf16
    with their neighbours."""
    nums = [s * x for s in (1.0, -1.0) for x in near + absolute]
    if variant != "bf16":
        return torch.tensor(np.array(nums, dtype=np.float32))
    b = _to_bf16(nums)
    return torch.cat([_bf16_steps(b, k) for k in range(-4, 5)]).unique()


def _reciprocals(variant, det):
    """The reciprocals of det the variant's pair math may take: None (the
    twin's) and, for `recipx`, the exact one moved by up to 16 ulps either
    way and flushed to zero where it is subnormal (rcp.approx.ftz.f32)."""
    if variant != "recipx":
        return [None]
    ok = det.abs() >= TRI_EPSILON
    exact = 1.0 / torch.where(ok, det, torch.ones_like(det))
    flushed = torch.where(exact.abs() < 2.0 ** -126,
                          torch.zeros_like(exact), exact)
    normal = torch.isfinite(exact) & (exact.abs() >= 2.0 ** -126)
    return [None, flushed] + [
        torch.where(normal, (exact.view(torch.int32) + k)
                    .view(torch.float32), flushed)
        for k in (-16, -4, -1, 1, 4, 16)]


@pytest.mark.parametrize("variant", VARIANTS)
def test_rule_margins(variant):
    """Numerators at each margin of the variant's rule, with either sign,
    against determinants at the twins' thresholds (1e-8; 2^126, above
    which 1/det is subnormal; the largest values, zero, -0.0, the least
    subnormal, inf, NaN): every pair the rule rejects is rejected by the
    variant's culls (`trace_ablation._mt_culls`, the twin's) with each
    reciprocal its kernel may take, and both keep some."""
    dets, rel, absolute = _margin_values(variant)
    dt = torch.bfloat16 if variant == "bf16" else torch.float32
    rejected = kept = 0
    for det, near in zip(dets, rel):
        nums = _numerators(variant, near, absolute)
        u = nums[:, None].expand(-1, nums.numel())
        v = nums[None, :].expand(nums.numel(), -1)
        dt_det = torch.full(u.shape, float(det)).to(dt)
        face, keep_u, keep_v = trace_ablation.variant_rule(variant, dt_det,
                                                           u, v)
        for x in (0.5, 2.0 ** -22, -0.5):
            # t·det giving t = x, and an absolute t·det near 2^-100.
            for t_num in ((dt_det.float() * x).to(dt),
                          torch.full(u.shape, 1.5 * 2.0 ** -100).to(dt)):
                for inv in _reciprocals(variant, dt_det):
                    _, ok = trace_ablation._mt_culls(dt_det, u, v, t_num,
                                                     variant, inv)
                    assert not bool((ok & ~keep_v).any()), (variant,
                                                            float(det), x)
                    kept += int(ok.sum())
        assert bool(face.all())
        assert not bool((keep_v & ~keep_u).any())
        rejected += int((~keep_v).sum())
    assert rejected > 0 and kept > 0


def _steps(x, k):
    """The values k steps (ulps) from each value of x, in its dtype."""
    if x.dtype == torch.bfloat16:
        return _bf16_steps(x, k)
    return (x.view(torch.int32) + k).view(torch.float32)


@pytest.mark.parametrize("rule", VARIANTS + ("mxu",))
def test_rules_near_their_bounds(rule):
    """Each rule on 400 random determinants (magnitudes 1e-8 to 1e30,
    either sign; bf16 values for `bf16`) and numerators within 24 steps
    of |det|, of 0 and of each of the rule's bounds, with either sign,
    the other numerator small and valid: no pair the rule rejects is kept
    by the variant's culls (with each reciprocal `recipx`'s kernel may
    take) or, for `mxu`, by pair_eval_raw's epilogue."""
    r = np.random.default_rng(12)
    variant = "recip" if rule == "mxu" else rule
    dt = torch.bfloat16 if rule == "bf16" else torch.float32
    mags = 10.0 ** r.uniform(-8, 30, 400) * r.choice([-1.0, 1.0], 400)
    det = torch.as_tensor(mags, dtype=torch.float32).to(dt)
    a = det.float().abs()
    lo_f, hi_f = trace_ablation.RULE_MARGINS.get(variant, (0.0, 1.0))
    centres = [a, torch.zeros_like(a), a * lo_f, a * hi_f]
    if rule == "mxu":
        centres += [a * (1.0 + 2.0 ** -21), a * 2.0 ** -21]
    w = torch.stack([_steps(c.to(dt), k) for c in centres
                     for k in range(-24, 25)], dim=1)
    w = torch.cat([w, -w], dim=1)                   # [400, M]
    num = torch.where(torch.signbit(det)[:, None], -w, w)
    small = (det.float() * 2.0 ** -30).to(dt)[:, None].expand_as(num)
    dd = det[:, None].expand_as(num)
    t_num = (dd.float() * 0.5).to(dt)
    rejected = 0
    for u, v in ((num, small), (small, num)):
        if rule == "mxu":
            keep = trace_ablation.mxu_bf16_rule(dd, u, v)
            t, ok, _ = trace_mxu.pair_epilogue(dd, u, v, t_num)
            oks = [ok & (t > trace_pallas.MIN_T)]
        else:
            keep = trace_ablation.variant_rule(variant, dd, u, v)[2]
            oks = [trace_ablation._mt_culls(dd, u, v, t_num, variant, inv)[1]
                   for inv in _reciprocals(variant, dd)]
        for ok in oks:
            assert not bool((ok & ~keep).any()), rule
        rejected += int((~keep).sum())
    assert rejected > 0


def test_culls_are_the_twins():
    """`_mt_culls` on the numerators of `_mt_numerators` is each variant's
    pair math: the margins test above holds the twins themselves."""
    o, d = _rays(64, seed=9)
    tb = _shell()[:, :256]
    for variant in VARIANTS:
        dt = torch.bfloat16 if variant == "bf16" else torch.float32
        nums = trace_ablation._mt_numerators(
            o.to(dt)[:, :, None], d.to(dt)[:, :, None], tb.to(dt)[:, None])
        t, ok = trace_ablation._mt_culls(*nums, variant)
        want, det = trace_ablation.variant_pairs(variant)(o, d, tb)
        assert torch.equal(torch.where(ok, t, torch.full_like(t, MISS)),
                           want)
        assert torch.equal(nums[0], det)


def _sweep_operands():
    """Small shells padded to whole sweep tiles (the outer one two
    concentric spheres, so that rays cross it forward twice), 1,024 camera
    rays from (0, 0, 3) and 512 rays from around and inside them, in three
    512-ray blocks of which the middle one is dead."""
    width = trace_pallas.SWEEP_TRI_TILE
    shells = []
    for radii in ((1.15, 1.0), (0.85,)):
        tp = torch.cat([outward_sphere(10, 20, r).to_tensors("cpu")
                        .tris_packed for r in radii], dim=1)
        pad = -(-tp.shape[1] // width) * width - tp.shape[1]
        shells.append(torch.nn.functional.pad(tp, (0, pad)))
    n = 1024
    w = int(np.sqrt(n * 16 / 9))
    xs = (np.arange(w) / w - 0.5) * 1.2
    ys = (np.arange(-(-n // w)) / -(-n // w) - 0.5) * 0.675
    gx, gy = np.meshgrid(xs, ys)
    d = np.stack([gx.ravel()[:n], gy.ravel()[:n], -np.ones(n)], axis=0)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = np.repeat(np.array([[0.0], [0.0], [3.0]]), n, axis=1)
    o2, d2 = _rays(512, seed=11, inside=0.5)
    origins = torch.cat([torch.as_tensor(o, dtype=torch.float32), o2], dim=1)
    dirs = torch.cat([torch.as_tensor(d, dtype=torch.float32), d2], dim=1)
    return (origins.contiguous(), dirs.contiguous(),
            torch.cat(shells, dim=1).contiguous(), shells[0].shape[1],
            torch.tensor([1, 0, 1], dtype=torch.int32))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("with_fwd2", [True, False])
def test_prefiltered_sweep_equals_the_twin(variant, with_fwd2):
    """The sweep with the variant's rule in front of its pair math (its
    kernel's walk) equals the unfiltered twin on every row, bit for bit."""
    o, d, tris, cols, mask = _sweep_operands()
    want = trace_pallas.sweep_shells_dense_twin(
        o, d, tris, cols, with_fwd2, mask,
        pairs=trace_ablation.variant_pairs(variant))
    got = trace_pallas.sweep_shells_dense_twin(
        o, d, tris, cols, with_fwd2, mask,
        pairs=trace_ablation.variant_pairs(variant, prefilter=True))
    assert (want[0] < MISS).sum() > 300 and (want[3] < MISS).sum() > 100
    if with_fwd2:
        assert (want[4] < MISS).sum() > 100
    assert torch.equal(got, want)


def test_variant_prefilter_pairs_counts_the_rule():
    """`variant_prefilter_pairs` counts the live blocks' pairs each test of
    the variant's rule leaves against the real triangles, as
    `trace_pallas.prefilter_pairs` does for K4's rule (`recip`'s)."""
    o, d, tris, _, mask = _sweep_operands()
    assert trace_ablation.variant_prefilter_pairs(o, d, tris, mask, "recip") \
        == trace_pallas.prefilter_pairs(o, d, tris, mask)
    live = torch.cat([torch.arange(512), torch.arange(1024, 1536)])
    real = tris[:, (tris[3:6] != 0).any(dim=0)]
    for variant in ("nodiv", "bf16"):
        face, ku, kv = trace_ablation.variant_prefilter(
            o[:, live, None], d[:, live, None], real[:, None, :], variant)
        got = trace_ablation.variant_prefilter_pairs(o, d, tris, mask,
                                                     variant)
        assert got == (int(face.sum()), int(ku.sum()), int(kv.sum()))
        assert got[0] == 1024 * real.shape[1] and got[1] > got[2] > 0


@pytest.mark.parametrize("passes", [1, 3])
def test_mxu_bf16_rule_rejects_only_pairs_the_twin_rejects(passes):
    """The bf16 matrix kernels' rule (`mxu_bf16_rule` on the f32 sums of
    the bf16 products) never rejects a pair the twin keeps, leaves few, and
    the prefiltered closest hit equals the twin's, t and ids."""
    o, d = _rays(1024, seed=4)
    tb = _shell()
    det, u, v, _ = trace_ablation.mxu_bf16_products(o, d, tb, passes)
    t, _ = trace_ablation.mxu_bf16_tile_t(o, d, tb, passes)
    hit = t < MISS
    keep = trace_ablation.mxu_bf16_rule(det, u, v)
    assert int(hit.sum()) > 400
    assert not bool((hit & ~keep).any())
    assert keep.double().mean().item() < 0.01
    tp = torch.nn.functional.pad(tb, (0, 2560 - tb.shape[1]))
    assert torch.equal(
        trace_ablation.trace_mxu_bf16_twin(o, d, tp, passes, prefilter=True),
        trace_ablation.trace_mxu_bf16_twin(o, d, tp, passes))


def test_mxu_bf16_rule_margins():
    """Numerators where |2 num - det| meets the rule's bound (w = num
    sgn(det) at |det| (-2^-20) and |det| (1 + 2^-20), the floats beside
    them, wider factors, tiny absolute values), with either sign, against
    determinants at the epilogue's thresholds: every pair the rule rejects
    is rejected by pair_eval_raw's epilogue (`trace_mxu.pair_epilogue`,
    then t > MIN_T), and both keep some."""
    dets, rel, absolute = _margin_values("recip")
    rejected = kept = 0
    for det, near in zip(dets, rel):
        nums = _numerators("recip", near, absolute)
        u = nums[:, None].expand(-1, nums.numel())
        v = nums[None, :].expand(nums.numel(), -1)
        dt = torch.full_like(u, float(det))
        keep = trace_ablation.mxu_bf16_rule(dt, u, v)
        for x in (0.5, 2.0 ** -22, -0.5):
            for t_num in (dt * x, torch.full_like(dt, 1.5 * 2.0 ** -100)):
                t, ok, _ = trace_mxu.pair_epilogue(dt, u, v, t_num.float())
                ok &= t > trace_pallas.MIN_T
                assert not bool((ok & ~keep).any()), (float(det), x)
                kept += int(ok.sum())
        rejected += int((~keep).sum())
    assert rejected > 0 and kept > 0


def test_mxu_bf16_rule_takes_the_fused_rounding():
    """rn(2 num - det) through float64 is the fused multiply-add's single
    rounding: equal to the exact value rounded once (fractions), on
    operands whose exponents differ by 0 to 60."""
    r = np.random.default_rng(8)
    from fractions import Fraction
    for k in range(61):
        num = np.float32(r.uniform(1, 2)) * np.float32(2.0 ** -k)
        det = np.float32(r.uniform(-2, 2))
        got = np.float32((2.0 * np.float64(num)) - np.float64(det))
        exact = 2 * Fraction(float(num)) - Fraction(float(det))
        lo = np.float32(float(exact))          # nearest f64, then f32
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                         int(np.float32(c).view(np.int32))
                                         & 1))
        assert got == best, (k, num, det)


def test_mxu_bf16_epilogue_pairs_counts_the_kernels_slots():
    """`mxu_bf16_epilogue_pairs` counts 32 pairs for each 8-ray x
    4-triangle slot of a 16 x 8 tile (rows g or g + 8, even or odd
    columns) in which the rule keeps a pair, in any chunking."""
    o, d = _rays(64, seed=6, inside=0.0)
    tb = outward_sphere(6, 12, 1.15).to_tensors("cpu").tris_packed[:, :128]
    det, u, v, _ = trace_ablation.mxu_bf16_products(o, d, tb, 3)
    keep = trace_ablation.mxu_bf16_rule(det, u, v)
    want = 0
    for r0 in range(0, 64, 16):
        for c0 in range(0, 128, 8):
            for h in range(2):
                for e in range(2):
                    rows = r0 + 8 * h + torch.arange(8)
                    cols = c0 + e + 2 * torch.arange(4)
                    want += 32 * int(keep[rows][:, cols].any())
    assert 0 < want < 64 * 128
    assert trace_ablation.mxu_bf16_epilogue_pairs(o, d, tb, 3) == want
    assert trace_ablation.mxu_bf16_epilogue_pairs(o, d, tb, 3, chunk=32) \
        == want
    assert trace_mxu.slot_count(keep) == want


def test_design_sweep_script_edits_the_committed_kernel(monkeypatch):
    """scripts/sweep_ablate_mxu_bf16.py builds its variants by replacing
    text of csrc/ablate_mxu_bf16.cu: every replacement still finds its
    text, and without a CUDA device the script exits non-zero."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "sweep_ablate_mxu_bf16",
        os.path.join(root, "scripts", "sweep_ablate_mxu_bf16.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(mod.CSRC, "ablate_mxu_bf16.cu")) as f:
        src = f.read()
    for name, edits in mod.VARIANTS.items():
        for old, _ in edits:
            assert old in src, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 2
