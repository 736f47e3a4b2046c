#!/usr/bin/env python3
"""Why the matrix-formulation trace kernels take FP64 products: emulate the
precisions a tensor core offers for the four bilinear products of
ops/trace_mxu.py and hold each against an independent reference, on the
CPU.

    python scripts/emulate_mxu_split.py [--rays 4096]

For spheres of several sizes and rays aimed from radius 3 at the centre
(the parity tests' geometry) and from radius 7 (the knot's camera
distance), the products F^T f are taken as:
  f32     f32 matmul, what the TPU's HIGHEST dots approximate and what
          the twins took before they took FP64 products;
  1xTF32  one pass of TF32 operands (10 explicit mantissa bits, rounded to
          nearest, ties away: cvt.rna.tf32.f32);
  3xTF32  hi = tf32(x), lo = tf32(x - hi); lo*hi + hi*lo + hi*hi;
  FP64    the f32 features widened, products and sums in float64, rounded
          once to f32 (what mma.sync.m8n8k4.f64 gives).
Each tensor-core pass is modelled as exact products summed in float64 and
rounded to f32 once per k8 step, an optimistic model of the accumulator.
The epilogue is the twin's (f32, JAX's order). The reference is
Möller–Trumbore in float64 from the same f32 vertices and rays (the
textbook form, independent of the feature rows): its t is exact to ~1e-15
where an f32 formulation's is exact to ~1e-7. Printed per case: hit flips
against the reference, the largest relative t difference where both hit,
how many rays fall outside |dt| <= 1e-6 + 1e-6 |t| (the JAX package's
kernel-against-twin bound, tests/test_trace_mxu.py:128-136), and the share
of equal ids.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from neural_renderer_tpu_torch.ops import trace_mxu  # noqa: E402
from neural_renderer_tpu_torch.scene.mesh import outward_sphere  # noqa: E402


def tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest, ties
    away from zero."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x1000) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


def _passes(a, b, terms):
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for x, y in terms:
        for k0 in (0, 8):
            acc = (acc.astype(np.float64)
                   + x[:, k0:k0 + 8].astype(np.float64)
                   @ y[k0:k0 + 8].astype(np.float64)).astype(np.float32)
    return acc


def product(kind: str):
    def run(a, b):
        if kind == "FP64":
            return (a.astype(np.float64) @ b.astype(np.float64)).astype(
                np.float32)
        ah, bh = tf32(a), tf32(b)
        if kind == "1xTF32":
            return _passes(a, b, [(ah, bh)])
        al, bl = tf32(a - ah), tf32(b - bh)
        return _passes(a, b, [(al, bh), (ah, bl), (ah, bh)])
    return run


def trace_exact(o, d, tp, mode):
    """Closest hit (t, id) per ray by Möller–Trumbore in float64."""
    o, d = o.T.astype(np.float64)[:, None], d.T.astype(np.float64)[:, None]
    v0, e1, e2 = (tp[3 * i:3 * i + 3].T.astype(np.float64)[None]
                  for i in range(3))
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    ok = np.abs(det) >= trace_mxu.TRI_EPSILON
    inv = 1.0 / np.where(ok, det, 1.0)
    s = o - v0
    u = (s * p).sum(-1) * inv
    q = np.cross(s, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    ok &= (t > trace_mxu.TRI_EPSILON) & (t > trace_mxu.MIN_T)
    if mode == 1:
        ok &= det > 0
    t = np.where(ok, t, 1e30)
    return t.min(axis=1), t.argmin(axis=1)


def trace(F, tp, mm, mode):
    """Closest hit (t, id) per ray with the twin's epilogue; mm the
    product [N, 16] x [16, T] -> [N, T]."""
    feats = trace_mxu.tri_features(torch.from_numpy(tp))
    a = F.T.astype(np.float32)
    det, u_num, v_num, t_num = (torch.from_numpy(mm(a, f.numpy()))
                                for f in feats)
    ok = det.abs() >= trace_mxu.TRI_EPSILON
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    u = u_num * inv
    ok &= (u >= 0) & (u <= 1)
    v = v_num * inv
    ok &= (v >= 0) & (u + v <= 1)
    t = t_num * inv
    ok &= (t > trace_mxu.TRI_EPSILON) & (t > trace_mxu.MIN_T)
    if mode == 1:
        ok &= det > 0
    t = torch.where(ok, t, torch.full_like(t, trace_mxu.MISS))
    best, idx = t.min(dim=1)
    return best.numpy(), idx.numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=4096)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(5)
    twin = lambda a, b: (torch.from_numpy(a) @ torch.from_numpy(b)).numpy()
    kinds = (("f32", twin), ("1xTF32", product("1xTF32")),
             ("3xTF32", product("3xTF32")), ("FP64", product("FP64")))
    for eye in (3.0, 7.0):
        o = rng.normal(size=(args.rays, 3))
        o = o / np.linalg.norm(o, axis=1, keepdims=True) * eye
        d = rng.normal(size=(args.rays, 3)) * 0.2 * eye - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = o.T.astype(np.float32), d.T.astype(np.float32)
        F = trace_mxu.ray_features(torch.from_numpy(o),
                                   torch.from_numpy(d)).numpy()
        for stacks, radius in ((8, 1.0), (24, 1.0), (48, 1.0), (24, 1.15)):
            mesh = outward_sphere(stacks, 2 * stacks,
                                  radius).to_tensors("cpu")
            tp = mesh.tris_packed[:, :mesh.num_triangles].numpy()
            for mode in (0, 1):
                ref_t, ref_id = trace_exact(o, d, tp, mode)
                for kind, mm in kinds:
                    t, ids = trace(F, tp, mm, mode)
                    both = (t < 1e30) & (ref_t < 1e30)
                    diff = np.abs(t[both] - ref_t[both])
                    out = int((diff > 1e-6 + 1e-6 * np.abs(ref_t[both]))
                              .sum())
                    print(f"eye {eye} sphere({stacks}, {2 * stacks}, "
                          f"r={radius}) mode {mode} {kind:6s}: flips "
                          f"{((t < 1e30) != (ref_t < 1e30)).mean():.5f}, "
                          f"max rel t "
                          f"{(diff / np.abs(ref_t[both])).max():.3e}, "
                          f"outside 1e-6: {out} of {int(both.sum())}, ids "
                          f"{(ids[both] == ref_id[both]).mean():.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
