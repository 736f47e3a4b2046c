"""The FP32 dense kernels' prefilter rule and its counts, on the CPU.

The dense closest hit (K3, csrc/trace_dense.cu) and the dense sweep (K4,
csrc/sweep_dense.cu) run Möller–Trumbore's divide and second half only on
the pairs their prefilter leaves (csrc/mt_dense.cuh::df_face, df_keep_u,
df_keep_v). `trace_pallas.dense_rule` is the prefilter's rule on a pair's
f32 det, u·det and v·det, `dense_prefilter` the rule on the twin's own
values, and `prefilter_pairs` counts what it leaves for the kernels'
bound. A pair the rule rejects must be one that the twin rejects too (the
kernels are held bit-exact to the twins on the card by
tests/test_torch_cuda.py): held here
on ray/triangle pairs of the parity tests' spheres, and on f32 numerators
placed at each of the rule's margins, where the twin's epilogue
(`trace_mxu.pair_epilogue`, the same operations as csrc/mt.cuh::nr_mt_t
once det, u·det, v·det and t·det are known) decides.
"""

import numpy as np
import pytest
import torch

from neural_renderer_tpu_torch.ops import trace_mxu, trace_pallas
from neural_renderer_tpu_torch.ops.trace_pallas import (MIN_T, MISS,
                                                        TRI_EPSILON)
from neural_renderer_tpu_torch.scene.mesh import outward_sphere

torch.set_num_threads(1)


def _rays(n, seed, inside=0.25):
    """n rays from radius 3 at random targets, a share from inside the
    shell."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(3, n))
    o = 3.0 * o / np.linalg.norm(o, axis=0)
    k = int(n * inside)
    o[:, :k] *= r.uniform(0.0, 0.35, k)
    d = r.uniform(-1.3, 1.3, size=(3, n)) - o
    d /= np.linalg.norm(d, axis=0)
    return tuple(torch.as_tensor(x, dtype=torch.float32) for x in (o, d))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_prefilter_rejects_only_rejected_pairs(mode):
    """On 1,000 rays x 2,304 triangles no pair the rule rejects is kept by
    the twin (`_mt_pairs` with the facing cull), the facing test is the
    twin's facing cull (every pair in ANY), each test keeps a subset of
    the one before, and together they leave few pairs a ray."""
    o, d = _rays(1000, seed=3)
    tb = outward_sphere(24, 48, 1.15).to_tensors("cpu").tris_packed
    o3, d3, tb3 = o[:, :, None], d[:, :, None], tb[:, None, :]
    t, det = trace_pallas._mt_pairs(o3, d3, tb3)
    hit = trace_pallas._mode_cull(t, det, mode) < MISS
    face, keep_u, keep_v = trace_pallas.dense_prefilter(o3, d3, tb3, mode)
    assert int(hit.sum()) > 400
    assert torch.equal(face, [torch.ones_like(face), det > 0.0,
                              det < 0.0][mode])
    assert not bool((hit & ~keep_v).any())
    assert not bool((keep_v & ~keep_u).any())
    assert not bool((keep_u & ~face).any())
    assert keep_u.double().mean().item() < 0.2
    assert keep_v.double().mean().item() < 0.01


def _f32(x):
    return np.float32(x)


def _margin_values():
    """f32 determinants at the rule's thresholds and numerators placed
    against them: relative to |det| (at |det|, at the rule's bounds
    |det| (-2^-20) and rn(|det| (1 + 2^-20)) and the floats beside them,
    and at wider factors) and absolute (tiny enough that u·det / det
    rounds to -0.0)."""
    up, down = np.inf, -np.inf
    eps = _f32(TRI_EPSILON)
    top = _f32(2.0 ** 126)
    mags = [np.nextafter(eps, _f32(0)), eps, np.nextafter(eps, _f32(1)),
            _f32(1e-3), _f32(0.7), _f32(1.0), _f32(3.0), _f32(2.0 ** 40),
            _f32(2.0 ** 100), np.nextafter(top, _f32(0)), top,
            _f32(2.0 ** 127), np.finfo(np.float32).max]
    dets = [s * m for s in (1.0, -1.0) for m in mags]
    dets += [_f32(0.0), _f32(-0.0), _f32(1e-45), _f32(up), _f32(down),
             _f32(np.nan)]
    lo_f, hi_f = _f32(trace_pallas.DENSE_LO), _f32(trace_pallas.DENSE_HI)
    rel = []
    with np.errstate(over="ignore", invalid="ignore"):
        for a in (abs(x) for x in dets):
            near = [a, np.nextafter(a, _f32(down)), np.nextafter(a, _f32(up))]
            for bound in (_f32(a * hi_f), _f32(a * lo_f)):
                near += [bound, np.nextafter(bound, _f32(down)),
                         np.nextafter(bound, _f32(up))]
            near += [_f32(a * f) for f in (0.0, 2.0 ** -23, 2.0 ** -21, 0.3,
                                           0.5, 1 + 2.0 ** -21, 2.0, 1e30)]
            rel.append(near)
    absolute = [_f32(2.0 ** -100), _f32(2.0 ** -60), _f32(2.0 ** -112),
                _f32(2.0 ** -140), _f32(1e-45), _f32(0.0)]
    return dets, rel, absolute


def _accepted(det, u_num, v_num, t_num, mode):
    """The twin keeps the pair: the epilogue's `ok`, t > MIN_T, the
    facing."""
    t, ok, d = trace_mxu.pair_epilogue(det, u_num, v_num, t_num)
    keep = ok & (t > MIN_T)
    if mode == 1:
        keep &= d > 0.0
    elif mode == 2:
        keep &= d < 0.0
    return keep


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_prefilter_margins(mode):
    """Numerators at each margin of the rule, with either sign, against
    determinants at the twin's thresholds (1e-8; 2^126, above which
    1/det is subnormal; the largest float, zero, -0.0, the least
    subnormal, inf, NaN): every pair the rule rejects is rejected by the
    twin's epilogue, and both keep some."""
    dets, rel, absolute = _margin_values()
    rejected = kept = 0
    for det, near in zip(dets, rel):
        nums = [s * x for s in (1.0, -1.0) for x in near + absolute]
        nums = torch.tensor(np.array(nums, dtype=np.float32))
        u = nums[:, None].expand(-1, nums.numel())
        v = nums[None, :].expand(nums.numel(), -1)
        dt = torch.full_like(u, float(det))
        face, keep_u, keep_v = trace_pallas.dense_rule(dt, u, v, mode)
        for x in (0.5, 2.0 ** -22, -0.5):
            # t·det giving t = x, and an absolute t·det near 2^-100.
            for t_num in (dt * x, torch.full_like(dt, 1.5 * 2.0 ** -100)):
                ok = _accepted(dt, u, v, t_num.float(), mode)
                assert not bool((ok & ~keep_v).any()), (float(det), x)
                kept += int(ok.sum())
        assert not bool((keep_v & ~keep_u).any())
        assert not bool((keep_u & ~face).any())
        rejected += int((~keep_v).sum())
    assert rejected > 0 and kept > 0


def test_underflowing_quotient_is_left_to_the_twin():
    """u·det of det's opposite sign whose quotient rounds to -0.0 passes the
    twin's u >= 0: the rule must leave it (the sign test is relative to
    |det|)."""
    det = torch.tensor([2.0 ** 100], dtype=torch.float32)
    u_num = torch.tensor([-2.0 ** -60], dtype=torch.float32)
    v_num = torch.tensor([2.0 ** 98], dtype=torch.float32)
    t_num = det * 0.5
    assert bool(_accepted(det, u_num, v_num, t_num, 0).all())
    assert bool(trace_pallas.dense_rule(det, u_num, v_num)[2].all())
    # Beyond the bound the rule rejects, and so does the twin.
    u_num = torch.tensor([-2.0 ** 80 * 1.5], dtype=torch.float32)
    assert not bool(trace_pallas.dense_rule(det, u_num, v_num)[1].any())
    assert not bool(_accepted(det, u_num, v_num, t_num, 0).any())


def test_prefilter_pairs_counts_the_live_blocks():
    """`prefilter_pairs` counts, over the live 512-ray blocks, the pairs
    each test leaves against every triangle with e1 != 0 (not the
    padding, nor a mesh's degenerate triangles), in any chunking; the
    facing test leaves every pair in ANY and those det's sign keeps in
    FORWARD_ONLY; all three leave every pair the twin keeps."""
    o, d = _rays(1536, seed=5, inside=0.0)
    mesh = outward_sphere(8, 16, 1.15).to_tensors("cpu")
    tb = torch.nn.functional.pad(mesh.tris_packed,
                                 (0, 1024 - mesh.tris_packed.shape[1]))
    # The pole fans' degenerate triangles have e1 = 0, like the padding.
    real = tb[:, (tb[3:6] != 0).any(dim=0), None]
    n = real.shape[1]
    assert 0 < n < mesh.num_triangles
    mask = torch.tensor([1, 0, 1], dtype=torch.int32)
    live = torch.cat([torch.arange(512), torch.arange(1024, 1536)])
    for mode in (0, 1):
        kf, ku, kv = trace_pallas.dense_prefilter(
            o[:, live, None], d[:, live, None], real.transpose(1, 2), mode)
        t, det = trace_pallas._mt_pairs(o[:, live, None], d[:, live, None],
                                        real.transpose(1, 2))
        hits = int((trace_pallas._mode_cull(t, det, mode) < MISS).sum())
        got = trace_pallas.prefilter_pairs(o, d, tb, mask, mode, chunk=300)
        assert got == (int(kf.sum()), int(ku.sum()), int(kv.sum()))
        assert got[1] > got[2] >= hits > 0
        if mode == 0:
            assert got[0] == 1024 * n
        else:
            assert 1024 * n > got[0] > got[1]
