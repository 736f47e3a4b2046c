"""Trace-kernel ablation on an NVIDIA GPU: what separates the dense
Möller–Trumbore trace kernels from their op-count bound.

The PyTorch/CUDA port of scripts/ablate_trace_kernel.py, on the same
workload and with the same columns. It times local variants of the dense
closest-hit trace (neural_renderer_tpu_torch/ops/trace_ablation.py):

  current      the production dense trace (csrc/trace_dense.cu)
  probe        a chain of 48 unfused FP32 operations per pair, same shapes:
               the attainable op rate
  local        the production trace's walk (K3's, at K3's launch) in the
               ablation's kernel (must match current)
  recip        1/det as a correctly rounded reciprocal
  recipx       1/det as the approximate reciprocal (rcp.approx.ftz.f32)
  nodiv        sign-trick culls, one divide for t only
  bf16         all Möller–Trumbore math in packed bf16
  b256/b1024   256 / 1024 rays per block; t256/t512/t1024 triangle tiles,
               and b256t256, t256probe, t256nodiv, b1024t512, t512probe
               (the port's block is the CTA's rays, its tile twice the
               staged chunk's triangles: trace_ablation.walk_shape)
  mxu_hi / mxu_hi3 / mxu_lo   the matrix formulation: K8 as the frame runs
               it (FP64 products) / with the TPU's bf16_3x products / with
               one bf16 pass

and the sweep family, the production dense dual-shell sweep (K4) on the
bench sphere's shells with camera rays: sweep, sweep_nof2 (no second
forward crossing), sweep_mxu (its matrix formulation) and sweep_nodiv,
sweep_recip, sweep_recipx, sweep_bf16 (its tile math replaced).

Usage: python scripts/ablate_trace_kernel_torch.py [variants...] [--tris N]
       [--rays N] [--reps N]
Defaults run the reference's list at 9,216 triangles x 262,144 rays x 8
reps, best of 3. Each time is taken with CUDA events over `reps` launches
back to back. Beside it: the bound (the least time the card could take:
the variant's operations over the card's peak rate for their type, see
ops/bounds.py), hitmm and terr against `current`, and for the sweep family
maxdiff against `sweep`. The kernels behind a prefilter (`current` and
the trace variants on its walk, every one but the probes; the sweep rows
but `sweep_mxu`, which counts its epilogue's pairs; mxu_hi3, mxu_lo) print
the bound on the pairs the prefilter leaves, the bound on every pair ("per
pair") and the share of pairs the rule leaves ("survivors").
Needs a CUDA device; runs every variant named and exits 1 if any failed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from neural_renderer_tpu_torch.ops import (  # noqa: E402
    bounds, trace_ablation, trace_mxu, trace_pallas)
from neural_renderer_tpu_torch.scene.mesh import outward_sphere  # noqa: E402

DEFAULT_VARIANTS = ["current", "probe", "local", "nodiv", "recip", "recipx",
                    "bf16", "b256", "b1024", "t256", "mxu_hi", "mxu_hi3",
                    "mxu_lo", "sweep", "sweep_nof2", "sweep_nodiv",
                    "sweep_recipx", "sweep_bf16"]


def card() -> str:
    """`nvidia-smi`'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def on_walk(label: str) -> bool:
    """Whether trace variant `label` runs K3's prefiltered walk: `current`
    (K3 itself) and the K9 kernels but the probes."""
    return label == "current" or (
        label in trace_ablation.TRACE_COMBOS
        and trace_ablation.TRACE_COMBOS[label][0] != "probe")


def tile_math(label: str) -> str:
    """The tile math of variant `label`: the sweep family's follows
    "sweep_"; the production trace and sweeps (current, sweep, sweep_nof2)
    run `local`'s."""
    math = (label[len("sweep_"):] if label.startswith("sweep_")
            else trace_ablation.TRACE_COMBOS.get(label, ("local",))[0])
    return math if math in bounds.FP32_OPS or math == "bf16" else "local"


def bound_ms(label: str, pairs: int, converted: int | None = None,
             left: tuple[int, int, int] | None = None) -> float:
    """The least time of variant `label` on `pairs` (ray, triangle) pairs:
    its operations over the peak rate for their type (ops/bounds.py); for
    the matrix forms the larger of the tensor products, the FP32 operations
    and, for the FP64 ones (K8, K4-MXU), the conversions of the `converted`
    pairs their prefilter leaves to the epilogue (for the bf16 ones, with
    `converted` None, the epilogue on every pair). `left`: the pairs a
    walk variant's or a sweep row's prefilter leaves (its facing, u and v
    tests), counted as bounds.dense_seconds does; None counts every pair
    at the variant's operations."""
    if label in ("mxu_hi", "sweep_mxu"):
        s = bounds.mxu_seconds(pairs, converted=converted)
    elif label in trace_ablation.MXU_BF16_PASSES:
        s = bounds.mxu_seconds(pairs, trace_ablation.MXU_BF16_PASSES[label],
                               converted)
    elif left is not None:
        s = bounds.dense_seconds(pairs, *left, math=tile_math(label))
    else:
        s = bounds.trace_seconds(tile_math(label), pairs)
    return s * 1e3


def timed(fn, reps: int) -> float:
    """Best of 3 of the mean ms per call over `reps` calls back to back,
    after one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def on_device(x, device):
    """numpy x as a contiguous f32 tensor on `device`."""
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)


def trace_workload(num_tris: int, n: int, device):
    """The reference's workload (:285-306): an outward UV sphere of about
    `num_tris` triangles and `n` rays from radius 3 aimed at N(0, 0.6^2)
    targets, numpy default_rng(0). Returns (origins, dirs [3, n] f32, tris
    [9, T] f32)."""
    stacks = max(4, int((num_tris / 4) ** 0.5))
    tris = outward_sphere(stacks, 2 * stacks, 1.0).to_tensors(
        device).tris_packed
    rng = np.random.default_rng(0)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0
    tgt = rng.normal(size=(n, 3)) * 0.6
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return on_device(o.T, device), on_device(d.T, device), tris


def sweep_workload(n: int, device):
    """`run_sweep_family`'s workload (:190-220): the bench sphere's shells
    (2,304 + 2,304 triangles, each padded to whole sweep tiles) and `n`
    camera rays from (0, 0, 3) on a 16:9 grid. Returns (origins, dirs,
    tris, outer_cols)."""
    width = trace_pallas.SWEEP_TRI_TILE
    shells = [padded(outward_sphere(24, 48, r).to_tensors(device)
                     .tris_packed, width) for r in (1.15, 0.85)]
    w = int(np.sqrt(n * 16 / 9))
    h = -(-n // w)
    xs = (np.arange(w) / w - 0.5) * 1.2
    ys = (np.arange(h) / h - 0.5) * 0.675
    gx, gy = np.meshgrid(xs, ys)
    d = np.stack([gx.ravel()[:n], gy.ravel()[:n], -np.ones(n)], axis=0)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = np.broadcast_to(np.array([0.0, 0.0, 3.0])[:, None], (3, n))
    return (on_device(o, device), on_device(d, device),
            torch.cat(shells, dim=1).contiguous(), shells[0].shape[1])


def padded(tris, tile: int):
    """tris [9, T] padded with zero (culled) triangles to whole tiles."""
    pad = -(-tris.shape[1] // tile) * tile - tris.shape[1]
    return torch.nn.functional.pad(tris, (0, pad)).contiguous()


def trace_fn(label: str, origins, dirs, tris):
    """(call, padded triangle count) of trace variant `label`: call(o)
    returns [2, N] (row 0 t, row 1 ids bitcast)."""
    n = origins.shape[1]
    ones = torch.ones(n // trace_pallas.BLOCK_RAYS, dtype=torch.int32,
                      device=origins.device)
    if label in ("current", "mxu_hi", *trace_ablation.MXU_BF16_PASSES):
        tp = padded(tris, trace_pallas.TRI_TILE)
        if label == "current":
            return (lambda o: trace_pallas.trace_dense(o, dirs, tp, 0, ones,
                                                       mxu=False),
                    tp.shape[1])
        if label == "mxu_hi":
            # K8 with an all-ones skip mask: the reference ablation passes
            # none (the frame path sends K3's).
            return (lambda o: trace_mxu.trace_dense_mxu(o, dirs, tp, 0, ones),
                    tp.shape[1])
        passes = trace_ablation.MXU_BF16_PASSES[label]
        return (lambda o: trace_ablation.trace_mxu_bf16(o, dirs, tp, passes),
                tp.shape[1])
    if label not in trace_ablation.TRACE_COMBOS:
        raise ValueError(f"unknown variant {label!r}")
    var, block, tile = trace_ablation.TRACE_COMBOS[label]
    if n % block:
        raise ValueError(f"--rays {n} is not a multiple of {label}'s "
                         f"{block}-ray block")
    tp = padded(tris, tile)
    return (lambda o: trace_ablation.trace_variant(o, dirs, tp, var, block,
                                                   tile), tp.shape[1])


def sweep_fn(label: str, origins, dirs, tris, outer_cols: int):
    """call(o) -> [5 or 4, N] of sweep-family variant `label`."""
    name = label[len("sweep_"):] if label != "sweep" else "current"
    ones = torch.ones(origins.shape[1] // trace_pallas.BLOCK_RAYS,
                      dtype=torch.int32, device=origins.device)
    if name in ("current", "nof2"):
        return lambda o: trace_pallas.sweep_shells_dense(
            o, dirs, tris, outer_cols, name != "nof2", ones, mxu=False)
    if name == "mxu":
        return lambda o: trace_pallas.sweep_shells_dense_mxu(
            o, dirs, tris, outer_cols, True, ones)
    if name not in trace_ablation.SWEEP_VARIANTS:
        raise ValueError(f"unknown variant {label!r}")
    return lambda o: trace_ablation.sweep_variant(
        o, dirs, tris, outer_cols, True, ones, name)


def run_trace_family(variants, num_tris: int, n: int, reps: int, device):
    """Time each trace variant and hold it against `current`; prints the
    reference's line per variant. Returns ({label: {"ms", "bound_ms", "out"}
    (with "pair_bound_ms" and "survivors" for the prefiltered kernels) or
    the exception that failed it}, (origins, dirs, tris))."""
    origins, dirs, tris = trace_workload(num_tris, n, device)
    print(f"workload: {tris.shape[1]} tris (pad "
          f"{padded(tris, trace_pallas.TRI_TILE).shape[1]}) x {n} rays x "
          f"{reps} reps", flush=True)
    ref = trace_fn("current", origins, dirs, tris)[0](origins)[0]
    ref_hit = ref < trace_pallas.MISS
    ones = torch.ones(n // trace_pallas.BLOCK_RAYS, dtype=torch.int32,
                      device=device)
    lefts = {}     # the pairs each tile math's rule leaves, counted once
    results = {}
    for label in variants:
        try:
            fn, tpad = trace_fn(label, origins, dirs, tris)
            ms = timed(lambda: fn(origins), reps)
            out = fn(origins)
            bt = out[0]
            hit = bt < trace_pallas.MISS
            both = hit & ref_hit
            mm = (hit != ref_hit).double().mean().item()
            terr = ((bt[both] - ref[both]).abs()
                    / ref[both].clamp_min(1e-6)).max().item() \
                if bool(both.any()) else 0.0
        except Exception as e:  # noqa: BLE001 - reported, then the run fails
            print(f"{label:8s}: FAILED {type(e).__name__}: {str(e)[:120]}",
                  flush=True)
            results[label] = e
            continue
        pairs = n * tpad
        converted = None
        tp = padded(tris, trace_pallas.TRI_TILE)
        if label == "mxu_hi":
            converted = trace_mxu.epilogue_pairs(origins, dirs, tp, ones, 0)
        elif label in trace_ablation.MXU_BF16_PASSES:
            converted = trace_ablation.mxu_bf16_epilogue_pairs(
                origins, dirs, tp, trace_ablation.MXU_BF16_PASSES[label])
        left = None
        if on_walk(label):
            math = tile_math(label)
            if math not in lefts:
                lefts[math] = trace_ablation.variant_prefilter_pairs(
                    origins, dirs, tris, ones, math)
            left = lefts[math]
        res = dict(ms=ms, bound_ms=bound_ms(label, pairs, converted, left),
                   out=out)
        line = (f"{label:8s}: {ms:7.3f} ms/call  {ms * 1e9 / pairs:6.2f} "
                f"ps/pair  {n / ms / 1e3:7.2f} Mrays/s   hitmm {mm:.1e} terr "
                f"{terr:.1e}   bound {res['bound_ms']:.3f} ms")
        if left is not None or label in trace_ablation.MXU_BF16_PASSES:
            res.update(pair_bound_ms=bound_ms(label, pairs),
                       survivors=(converted if left is None else left[2])
                       / pairs)
            line += (f" (per pair {res['pair_bound_ms']:.3f} ms, survivors "
                     f"{res['survivors']:.3e})")
        print(line, flush=True)
        results[label] = res
    return results, (origins, dirs, tris)


def run_sweep_family(variants, n: int, reps: int, device):
    """Time each sweep variant and hold rows 0-3 against `sweep`'s (the
    reference's maxdiff, 1e30 meaning a miss). Returns results as
    `run_trace_family`."""
    origins, dirs, tris, outer_cols = sweep_workload(n, device)
    print(f"sweep family (production dual-shell kernel, {n} rays):",
          flush=True)
    ref = sweep_fn("sweep", origins, dirs, tris, outer_cols)(origins)
    miss = trace_pallas.MISS
    results = {}
    for label in variants:
        try:
            fn = sweep_fn(label, origins, dirs, tris, outer_cols)
            ms = timed(lambda: fn(origins), reps)
            out = fn(origins)
            err = (out[:4].clamp_max(miss) - ref[:4].clamp_max(miss)).abs() \
                .max().item()
        except Exception as e:  # noqa: BLE001 - reported, then the run fails
            print(f"{label:12s}: FAILED {type(e).__name__}: "
                  f"{str(e)[:120]}", flush=True)
            results[label] = e
            continue
        pairs = n * tris.shape[1]
        ones = torch.ones(n // trace_pallas.BLOCK_RAYS, dtype=torch.int32,
                          device=device)
        if label == "sweep_mxu":
            res = dict(ms=ms, out=out, bound_ms=bound_ms(
                label, pairs, trace_mxu.epilogue_pairs(origins, dirs, tris,
                                                       ones, 0)))
            extra = ""
        else:
            math = tile_math(label)
            left = (trace_pallas.prefilter_pairs(origins, dirs, tris, ones)
                    if math == "local" else
                    trace_ablation.variant_prefilter_pairs(
                        origins, dirs, tris, ones, math))
            res = dict(ms=ms, out=out, bound_ms=bound_ms(label, pairs,
                                                         left=left),
                       pair_bound_ms=bound_ms(label, pairs),
                       survivors=left[2] / pairs)
            extra = (f" (per pair {res['pair_bound_ms']:.3f} ms, survivors "
                     f"{res['survivors']:.3e})")
        print(f"{label:12s}: {ms:7.3f} ms/call  {ms * 1e6 / n:6.2f} ns/ray  "
              f"{n / ms / 1e3:7.2f} Mrays/s  maxdiff {err:.2e}   bound "
              f"{res['bound_ms']:.3f} ms{extra}", flush=True)
        results[label] = res
    return results, (origins, dirs, tris, outer_cols)


def run(variants=None, num_tris: int = 9216, n: int = 262144, reps: int = 8,
        device="cuda"):
    """The ablation as `main` runs it: returns (trace results, sweep
    results, trace workload, sweep workload); a failed variant's result is
    its exception."""
    variants = list(variants or DEFAULT_VARIANTS)
    sweep_vs = [v for v in variants if v == "sweep" or v.startswith("sweep_")]
    trace_vs = [v for v in variants if v not in sweep_vs]
    traces, trace_wl = run_trace_family(trace_vs, num_tris, n, reps, device)
    sweeps, sweep_wl = {}, None
    if sweep_vs:
        if "sweep" not in sweep_vs:
            sweep_vs.insert(0, "sweep")  # the diff reference
        sweeps, sweep_wl = run_sweep_family(sweep_vs, n, reps, device)
    return traces, sweeps, trace_wl, sweep_wl


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    def opt(name, default):
        if name not in argv:
            return default
        i = argv.index(name)
        val = int(argv[i + 1])
        del argv[i:i + 2]
        return val

    num_tris = opt("--tris", 9216)
    n = opt("--rays", 262144)
    reps = opt("--reps", 8)
    if not torch.cuda.is_available():
        print("ablate_trace_kernel_torch: no CUDA device; the ablation "
              "times the kernels on the GPU only", file=sys.stderr)
        return 2
    print(card(), flush=True)
    t0 = time.perf_counter()
    traces, sweeps, _, _ = run(argv or None, num_tris, n, reps)
    failed = [k for k, v in {**traces, **sweeps}.items()
              if isinstance(v, Exception)]
    print(f"total {time.perf_counter() - t0:.1f} s; failed: "
          f"{failed or 'none'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
