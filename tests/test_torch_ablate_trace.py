"""The port's trace-kernel ablation (ops/trace_ablation.py, the twins of
the K9 kernels) against the JAX script scripts/ablate_trace_kernel.py, on
the CPU.

The JAX script is loaded from its path, with its compile cache off, and
run in Pallas interpret mode (its module's INTERPRET, read when
`trace_variant` traces). Tolerances:

- The tile math, op by op (JAX under `jax.disable_jit()`): bit-exact in t
  and det for local, nodiv, bf16 and the probe. recip and recipx take
  `pl.reciprocal`, which has no evaluation rule outside a kernel.
- `trace_variant` in interpret mode, every variant of the script's
  dispatch: hits and ids equal on every ray, t within 16 ulp. The
  interpreted kernel runs as one XLA:CPU program, which contracts
  multiply-adds (measured here: up to 9 ulp); the port rounds op by op, as
  its -fmad=false kernels do. The probe's chain contracts 24 times: within
  24 ulp (measured: 14). bf16 is exact (its products are exact in f32, so
  contraction cannot move them; measured: 0 ulp).
- recipx: JAX's interpret lowering takes a bf16 reciprocal, where the TPU
  takes its hardware approximation and the port's twin the exact
  reciprocal (the card's rcp.approx is held to it in test_torch_cuda.py).
  So it is held loosely: hits differ on at most 1% of rays, ids on at most
  2% of rays hit in both, and t within 1e-2 relative where both take the
  same triangle (bf16 keeps 8 bits: 2^-8 relative per rounding).
- The sweep family (the JAX module's `_mt_tile_t` patched as
  `run_sweep_family` does): rows as `trace_variant`'s.
- mxu_hi3 / mxu_lo: XLA:CPU ignores a dot's `precision`, so the JAX run
  computes f32 products. The test builds the TPU's bf16 passes itself from
  JAX's `ray_features` / `tri_features` (op by op), rounded to bf16 in
  numpy, products summed in float64 and rounded once: the port's twin
  equals it.
- The bounds' operation counts (ops/bounds.py): each twin's per-pair
  arithmetic, counted as PyTorch dispatches it, equals the count its
  kernel's bound takes.

Figures print with -s.
"""

import collections
import importlib.util
import numbers
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from neural_renderer_tpu.ops import trace_mxu as jtm
from neural_renderer_tpu.ops import trace_pallas as jtp

from util import outward_sphere

from neural_renderer_tpu_torch.ops import (bounds, trace_ablation,
                                           trace_mxu, trace_pallas)

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULPS = 16
PROBE_ULPS = 24


@pytest.fixture(scope="module")
def jax_ablate():
    """scripts/ablate_trace_kernel.py as a module, in interpret mode."""
    saved = os.environ.get("NR_NO_COMPILE_CACHE")
    os.environ["NR_NO_COMPILE_CACHE"] = "1"
    try:
        spec = importlib.util.spec_from_file_location(
            "ablate_trace_kernel",
            os.path.join(ROOT, "scripts", "ablate_trace_kernel.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            os.environ.pop("NR_NO_COMPILE_CACHE")
        else:
            os.environ["NR_NO_COMPILE_CACHE"] = saved
    mod.INTERPRET = True
    return mod


def _rays(n, seed=0):
    """The script's rays (:299-306): from radius 3 at N(0, 0.6^2) targets;
    [3, n] f32 numpy."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0
    d = rng.normal(size=(n, 3)) * 0.6 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.T.astype(np.float32).copy(), d.T.astype(np.float32).copy()


def _tris(stacks, width):
    """An outward sphere's packed triangles padded to whole tiles."""
    tp = np.asarray(outward_sphere(stacks, 2 * stacks, 1.0)
                    .to_arrays().tris_packed)
    pad = -(-tp.shape[1] // width) * width - tp.shape[1]
    return np.pad(tp, ((0, 0), (0, pad)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _ulps(got, want):
    """Largest |got - want| in f32 ulps of want, over finite want."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want) / np.spacing(np.abs(want)),
                        initial=0.0))


def _hold_hits(label, got_t, want_t, got_id=None, want_id=None):
    """Hits (t below the miss) and ids equal, t within ULPS on the hits."""
    miss = np.float32(1e30)
    hit_g, hit_w = got_t < miss, want_t < miss
    ulps = _ulps(got_t[hit_w], want_t[hit_w])
    print(f"{label}: hits {int(hit_w.sum())}, flips "
          f"{int((hit_g != hit_w).sum())}, max ulps {ulps}")
    assert np.array_equal(hit_g, hit_w) and hit_w.sum() > 100
    assert np.array_equal(got_t[~hit_w], want_t[~hit_w])
    if got_id is not None:
        assert np.array_equal(got_id, want_id)
    assert ulps <= ULPS


@pytest.mark.parametrize("variant", ["local", "nodiv", "bf16", "probe"])
def test_tile_math_bit_exact(jax_ablate, variant):
    """`_mt_tile` / `_probe_tile` op by op against the port's tile math."""
    o, d = _rays(512, seed=1)
    tb = _tris(16, 256)[:, :256]
    with jax.disable_jit():
        if variant == "probe":
            jt = jax_ablate._probe_tile(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(tb), 48, 512, 256)[0]
            jd = None
        else:
            jt, jd = jax_ablate._mt_tile(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(tb), variant)
    if variant == "probe":
        pt = trace_ablation._probe(_t(o), _t(d), _t(tb))
    else:
        pt, pd = trace_ablation._mt_variant(_t(o), _t(d), _t(tb), variant)
        assert np.array_equal(pd.float().numpy(),
                              np.asarray(jd.astype(jnp.float32)))
    jt = np.asarray(jt.astype(jnp.float32))
    assert np.array_equal(pt.float().numpy(), jt)
    assert (jt < 1e30).sum() > 100


@pytest.mark.parametrize("label", list(trace_ablation.TRACE_COMBOS))
def test_trace_variant_matches_jax(jax_ablate, label):
    """Each variant's twin against the interpreted `trace_variant`."""
    var, block, tile = trace_ablation.TRACE_COMBOS[label]
    o, d = _rays(1024)
    tp = _tris(12, tile)
    jt, jid = jax_ablate.trace_variant(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(tp), var, block, tile,
                                       tp.shape[1] // tile)
    jt, jid = np.asarray(jt), np.asarray(jid)
    out = trace_ablation.trace_variant(_t(o), _t(d), _t(tp), var, block,
                                       tile)
    pt, pid = out[0].numpy(), out[1].view(torch.int32).numpy()
    if var == "bf16":
        assert np.array_equal(pt, jt) and np.array_equal(pid, jid)
        assert pt.max() == np.float32(trace_ablation.BF16_MISS)
    elif var == "recipx":
        _hold_recipx(label, pt, jt, pid, jid)
    elif var == "probe":
        assert (pid == 0).all() and (jid == 0).all()
        ulps = _ulps(pt, jt)
        print(f"{label}: max ulps {ulps}")
        assert ulps <= PROBE_ULPS
    else:
        _hold_hits(label, pt, jt, pid, jid)


def _hold_recipx(label, pt, jt, pid=None, jid=None):
    hit_p, hit_j = pt < 1e30, jt < 1e30
    flips = float(np.mean(hit_p != hit_j))
    both = hit_p & hit_j
    same = both if pid is None else both & (pid == jid)
    rel = float(np.max(np.abs(pt[same] - jt[same]) / jt[same], initial=0.0))
    ids = 1.0 if pid is None else float(np.mean(pid[both] == jid[both]))
    print(f"{label}: hits {int(hit_j.sum())}, flips {flips:.2e}, ids "
          f"{ids:.4f}, max rel t on the same triangle {rel:.2e}")
    assert flips <= 1e-2 and ids >= 0.98 and rel <= 1e-2
    assert same.sum() > 100


@pytest.mark.parametrize("variant", trace_ablation.SWEEP_VARIANTS)
def test_sweep_variant_matches_jax(jax_ablate, variant):
    """The sweep family: the production JAX sweep with `_mt_tile_t`
    patched, interpreted, against `sweep_variant`'s twin; small shells,
    camera rays from (0, 0, 3) as `run_sweep_family`'s."""
    width = jtp.SWEEP_TRI_TILE
    shells = [_pad_outward(r, width) for r in (1.15, 0.85)]
    tris = np.concatenate(shells, axis=1)
    n = 1024
    w = int(np.sqrt(n * 16 / 9))
    xs = (np.arange(w) / w - 0.5) * 1.2
    ys = (np.arange(-(-n // w)) / -(-n // w) - 0.5) * 0.675
    gx, gy = np.meshgrid(xs, ys)
    d = np.stack([gx.ravel()[:n], gy.ravel()[:n], -np.ones(n)], axis=0)
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(np.float32([0, 0, 3])[:, None], (3, n)).copy()
    orig = jtp._mt_tile_t
    jtp._mt_tile_t = jax_ablate._mt_variant_fn(variant)
    jtp._sweep_shells_pallas.clear_cache()
    try:
        want = np.asarray(jtp.sweep_shells_pallas(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris),
            shells[0].shape[1] // width, tris.shape[1] // width,
            with_fwd2=True, mxu=False, interpret=True))
    finally:
        jtp._mt_tile_t = orig
        jtp._sweep_shells_pallas.clear_cache()
    got = trace_ablation.sweep_variant(
        _t(o), _t(d), _t(tris), shells[0].shape[1], True,
        torch.ones(n // 512, dtype=torch.int32), variant).numpy()
    assert got.shape == want.shape == (5, n)
    if variant == "bf16":
        assert np.array_equal(got, want)
        return
    for row in range(4):
        if variant == "recipx":
            _hold_recipx(f"{variant} row {row}", got[row], want[row])
        else:
            _hold_hits(f"{variant} row {row}", got[row], want[row])
    assert np.array_equal(got[4] < 1e30, want[4] < 1e30)


def _pad_outward(radius, width):
    tp = np.asarray(outward_sphere(8, 16, radius).to_arrays().tris_packed)
    pad = -(-tp.shape[1] // width) * width - tp.shape[1]
    return np.pad(tp, ((0, 0), (0, pad)))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("label", list(trace_ablation.MXU_BF16_PASSES))
def test_mxu_bf16_twin_matches_tpu_passes(label):
    """mxu_hi3 / mxu_lo: the twin against the TPU's bf16 passes built from
    JAX's feature rows; ANY mode, smallest id among equal t."""
    passes = trace_ablation.MXU_BF16_PASSES[label]
    o, d = _rays(512, seed=2)
    tp = _tris(16, 512)
    with jax.disable_jit():
        F = np.asarray(jtm.ray_features(jnp.asarray(o), jnp.asarray(d)))
        feats = [np.asarray(f) for f in jtm.tri_features(jnp.asarray(tp))]

    def parts(x):
        hi = _bf16(x)
        return [hi] if passes == 1 else [hi, _bf16(x - hi)]

    fp = [p.astype(np.float64) for p in parts(F)]
    terms = [(0, 0)] if passes == 1 else [(0, 0), (0, 1), (1, 0)]
    det, u_num, v_num, t_num = (
        sum(fp[i].T @ tq[j] for i, j in terms).astype(np.float32)
        for tq in ([p.astype(np.float64) for p in parts(f)] for f in feats))
    one = np.float32(1.0)
    ok = np.abs(det) >= np.float32(1e-8)
    inv = one / np.where(ok, det, one)
    u = u_num * inv
    ok &= (u >= 0) & (u <= 1)
    v = v_num * inv
    ok &= (v >= 0) & (u + v <= 1)
    t = t_num * inv
    ok &= (t > np.float32(1e-8)) & (t > np.float32(1e-6))
    t = np.where(ok, t, np.float32(1e30))
    want_t = t.min(axis=1)
    want_id = np.argmin(t, axis=1).astype(np.int32)   # first among equal
    out = trace_ablation.trace_mxu_bf16(_t(o), _t(d), _t(tp), passes)
    got_t, got_id = out[0].numpy(), out[1].view(torch.int32).numpy()
    hit = want_t < 1e30
    print(f"{label}: hits {int(hit.sum())}, t equal "
          f"{np.array_equal(got_t, want_t)}")
    assert hit.sum() > 100
    assert np.array_equal(got_t, want_t)
    assert np.array_equal(got_id[hit], want_id[hit])


def test_wrappers_refuse_what_no_kernel_takes():
    """A combination outside the script's dispatch, or a ray count the
    block does not divide, raises on every device."""
    o, d = (_t(x) for x in _rays(1024))
    tp = _t(_tris(16, 128))
    with pytest.raises(ValueError):
        trace_ablation.trace_variant(o, d, tp, "nodiv", 1024, 128)
    with pytest.raises(ValueError):
        trace_ablation.trace_variant(o[:, :768], d[:, :768], tp, "local",
                                     512, 128)
    with pytest.raises(ValueError):
        trace_ablation.trace_mxu_bf16(o, d, tp, 2)
    ones = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        trace_ablation.sweep_variant(o, d, tp[:, :512], 256, True, ones,
                                     "probe")


def test_ablation_driver_needs_a_gpu(monkeypatch):
    """Without a CUDA device the driver exits non-zero and never runs the
    twins in place of the kernels."""
    spec = importlib.util.spec_from_file_location(
        "ablate_trace_kernel_torch",
        os.path.join(ROOT, "scripts", "ablate_trace_kernel_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["local", "--rays", "1024"]) != 0
    assert mod.DEFAULT_VARIANTS[0] == "current"
    # The driver refuses a ray count that the variant's block does not
    # divide (the reference's grid drops the ragged last block).
    with pytest.raises(ValueError):
        mod.trace_fn("b1024", *(_t(x) for x in _rays(1000)),
                     _t(_tris(16, 128)))


class _PairOps(TorchDispatchMode):
    """Counts the operations PyTorch dispatches on [N, T] pair tensors, by
    the rule of ops/bounds.py: arithmetic (add, sub, mul, div, reciprocal;
    not `1.0 / x`'s multiply by 1) per dtype, conversions and products;
    compares, selects and abs are not counted."""

    ARITH = {"add", "sub", "mul", "div", "reciprocal"}

    def __init__(self, numel):
        super().__init__()
        self.numel = numel
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if isinstance(out, torch.Tensor) and out.numel() == self.numel:
            one = any(isinstance(a, numbers.Number) and a == 1 for a in args)
            if name in self.ARITH and not (name == "mul" and one):
                self.ops[str(out.dtype)] += 1
            elif name == "_to_copy":
                self.ops["convert"] += 1
            elif name in ("mm", "bmm"):
                self.ops["product"] += 1
        return out


@pytest.mark.parametrize("math", ["local", "recip", "recipx", "nodiv",
                                  "probe", "bf16", "mxu", "mxu_prefilter",
                                  "dense_prefilter", "dense_second_test",
                                  "mt_pairs", "dense_facing",
                                  "dense_first_test", "mxu_bf16_prefilter",
                                  "variant_prefilter_recipx",
                                  "variant_prefilter_nodiv",
                                  "variant_prefilter_bf16"])
def test_bound_counts_are_the_twins_operations(math):
    """Each pair function's operations, as its twin performs them, are the
    count its bound takes (ops/bounds.py): 46 for Möller–Trumbore (the
    ablation's `local` and the production twin `_mt_pairs`), 47 for nodiv,
    50 for the probe, bf16's 45 packed operations and its divide, the
    matrix form's 4 products, 4 conversions and 5-operation epilogue, the
    matrix kernels' prefilter's 3 operations (the bf16-product kernels'
    3 too), and the FP32 dense kernels' prefilter: det and the facing test 14,
    the u test 10, the v test 14, all three 38, and with the rest of
    Möller–Trumbore (10) the 46 less the rule's 2 multiplies; the sweep
    variants' rules (PREFILTER_OPS, BF16_PREFILTER_*) likewise."""
    rng = np.random.default_rng(3)
    n, t = 7, 11                 # no per-ray or per-triangle tensor has N T
    o, d = (_t(rng.normal(size=(3, n)).astype(np.float32))
            for _ in range(2))
    tb = _t(rng.normal(size=(9, t)).astype(np.float32))

    def pair_operands(k):
        return [_t(rng.normal(size=(n, t)).astype(np.float32))
                for _ in range(k)]

    with _PairOps(n * t) as c:
        if math == "probe":
            trace_ablation._probe(o, d, tb)
        elif math == "mxu":
            trace_mxu.mxu_tile_t(o, d, tb)
        elif math == "mxu_prefilter":
            det, u, v = (_t(rng.normal(size=(n, t))) for _ in range(3))
            trace_mxu.certain_miss(det, u, v)
        elif math == "dense_prefilter":
            trace_pallas.dense_prefilter(o[:, :, None], d[:, :, None],
                                         tb[:, None, :], 1)
        elif math == "dense_facing":
            det, _ = trace_pallas._mt_det(d[:, :, None], tb[:, None, :])
            trace_pallas._dense_facing(det, 1)
        elif math == "dense_first_test":
            det, px, py, pz = pair_operands(4)
            u_num, _ = trace_pallas._mt_u_num(o[:, :, None], tb[:, None, :],
                                              (px, py, pz))
            lo, hi = trace_pallas._dense_bounds(det)
            trace_pallas._dense_out(u_num, det, lo, hi)
        elif math == "dense_second_test":
            det, u = pair_operands(2)
            v_num, _ = trace_pallas._mt_v_num(d[:, :, None], tb[:, None, :],
                                              pair_operands(3))
            trace_pallas._dense_out(v_num, det, u, -u)
        elif math == "mt_pairs":
            trace_pallas._mt_pairs(o[:, :, None], d[:, :, None],
                                   tb[:, None, :])
        elif math == "mxu_bf16_prefilter":
            trace_ablation.mxu_bf16_rule(*pair_operands(3))
        elif math.startswith("variant_prefilter_"):
            trace_ablation.variant_prefilter(
                o[:, :, None], d[:, :, None], tb[:, None, :],
                math[len("variant_prefilter_"):])
        else:
            trace_ablation._mt_variant(o, d, tb, math)
    dense = {"dense_prefilter": bounds.DENSE_DET + bounds.DENSE_U
             + bounds.DENSE_V, "dense_facing": bounds.DENSE_DET,
             "dense_first_test": bounds.DENSE_U,
             "dense_second_test": bounds.DENSE_V}
    if math == "mxu":
        assert c.ops == {"torch.float32": bounds.MXU_EPILOGUE,
                         "convert": bounds.MXU_CONVERSIONS, "product": 4}
    elif math == "mxu_prefilter":
        assert c.ops == {"torch.float32": bounds.MXU_PREFILTER}
    elif math == "mxu_bf16_prefilter":
        # Its two fused multiply-adds are taken as a float64 multiply and
        # subtract each, between conversions.
        assert c.ops == {"torch.float32": 1, "torch.float64": 4,
                         "convert": 5}
        assert 1 + 4 // 2 == bounds.MXU_BF16_PREFILTER
    elif math == "variant_prefilter_bf16":
        assert c.ops == {"torch.bfloat16":
                         sum(bounds.BF16_PREFILTER_PACKED[:3]),
                         "torch.float32": 2, "convert": 3}
        assert sum(bounds.BF16_PREFILTER_FP32[:3]) == 2 + 3
        assert sum(bounds.BF16_PREFILTER_PACKED) == bounds.BF16_PACKED_OPS
        assert sum(bounds.BF16_PREFILTER_FP32) - 4 == bounds.BF16_FP32_OPS
    elif math.startswith("variant_prefilter_"):
        var = math[len("variant_prefilter_"):]
        assert c.ops == {"torch.float32": sum(bounds.PREFILTER_OPS[var][:3])}
        assert sum(bounds.PREFILTER_OPS[var]) - (2 if var != "nodiv" else 0) \
            == bounds.FP32_OPS[var]
    elif math in dense:
        assert c.ops == {"torch.float32": dense[math]}
    elif math == "mt_pairs":
        assert c.ops == {"torch.float32": bounds.MT_OPS}
        assert bounds.DENSE_DET + bounds.DENSE_U + bounds.DENSE_V \
            + bounds.DENSE_REST - 2 == bounds.MT_OPS
    elif math == "bf16":
        assert c.ops == {"torch.bfloat16": bounds.BF16_PACKED_OPS + 1}
    else:
        assert c.ops == {"torch.float32": bounds.FP32_OPS[math]}
