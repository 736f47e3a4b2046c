"""The shell network of the plain reference: the lane-local hash grid,
the degree-4 spherical-harmonics direction code and the bias-free
LeakyReLU MLP, read from the exported `.npz` weights and evaluated in
float32 with TF32 off (or, for the lower-precision control, with the
tables, weights and every layer's input rounded to float8 e4m3).

Written from the network's definition (the reference renderer's NBVH
network: 3 points x 8 levels x 4 features + 16 SH terms = 112 inputs,
4 x 128 hidden, 16 outputs: 0 presence logit, 1 distance, 2:5 normal,
5:8 colour); the lane grid is tcnn's coherent prime hash into tables of
S x pack x 128 entries per (point, level, feature).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
LEAKY_SLOPE = 0.01
# Segments encoded at once (the [N, 112] stack and its gathers).
ROWS_PER_BLOCK = 1 << 20


class Network:
    def __init__(self, lane, mlp, base_resolution: int,
                 per_level_scale: float = 2.0, precision: str = "f32"):
        """lane [P, L, F, S, (pack,) 128] and the MLP's [out, in] matrices,
        float32 tensors (leaves that may require grad); precision "f32"
        (the reference) or "fp8" (the control)."""
        self.lane = lane
        self.mlp = list(mlp)
        self.precision = precision
        self.base_resolution = base_resolution
        self.per_level_scale = per_level_scale

    @staticmethod
    def from_npz(npz_path: str, base_resolution: int, device,
                 precision: str = "f32") -> "Network":
        with np.load(npz_path) as z:
            lane = torch.as_tensor(z["lane"], device=device)
            n_mlp = sum(1 for k in z.files if k.startswith("mlp_"))
            mlp = [torch.as_tensor(z[f"mlp_{i}"], device=device)
                   for i in range(n_mlp)]
        return Network(lane, mlp, base_resolution, 2.0, precision)

    def parameters(self) -> list:
        return [self.lane] + self.mlp

    def _q(self, x):
        """x rounded to float8 e4m3 under the control, with the identity's
        gradient; x itself otherwise."""
        if self.precision == "fp8":
            q = x.to(torch.float8_e4m3fn).to(torch.float32)
            return x + (q - x).detach()
        return x

    def _encode_point(self, tables_p, x):
        """[N, L * F] features of points x [3, N]."""
        levels, feats, entries = tables_p.shape
        out = []
        for level in range(levels):
            scale = torch.tensor(
                2.0 ** (level * math.log2(self.per_level_scale))
                * self.base_resolution - 1.0, dtype=torch.float32,
                device=x.device)
            p = x * scale + 0.5
            corner = torch.floor(p)
            w = p - corner
            c0 = corner.to(torch.int64)
            acc = None
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        h = ((c0[0] + dx) * PRIMES[0]) \
                            ^ ((c0[1] + dy) * PRIMES[1]) \
                            ^ ((c0[2] + dz) * PRIMES[2])
                        idx = h & (entries - 1)
                        wc = ((w[0] if dx else 1.0 - w[0])
                              * (w[1] if dy else 1.0 - w[1])
                              * (w[2] if dz else 1.0 - w[2]))
                        term = tables_p[level][:, idx] * wc[None, :]
                        acc = term if acc is None else acc + term
            out.append(acc)
        return torch.cat(out, dim=0).T

    @staticmethod
    def _sh(d01):
        d = d01 * 2.0 - 1.0
        x, y, z = d[0], d[1], d[2]
        xy, xz, yz = x * y, x * z, y * z
        x2, y2, z2 = x * x, y * y, z * z
        return torch.stack([
            torch.full_like(x, 0.28209479177387814),
            -0.48860251190291987 * y, 0.48860251190291987 * z,
            -0.48860251190291987 * x, 1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2)], dim=1)

    def __call__(self, inputs):
        """inputs [12, N] ([entry | exit | mid | dir01], each in [0, 1]^3)
        -> outputs [16, N] f32."""
        n = inputs.shape[1]
        p, levels, feats = self.lane.shape[:3]
        # [P, L, F, entries]: entry = sub * (pack * 128) + half * 128 + lane.
        tables = self._q(self.lane.reshape(p, levels, feats, -1))
        mlp = [self._q(w) for w in self.mlp]
        outs = []
        for s in range(0, n, ROWS_PER_BLOCK):
            x = inputs[:, s:s + ROWS_PER_BLOCK]
            h = torch.cat([self._encode_point(tables[i], x[3 * i:3 * i + 3])
                           for i in range(p)] + [self._sh(x[9:12])], dim=1)
            for i, w in enumerate(mlp):
                h = self._q(h) @ w.T
                if i < len(mlp) - 1:
                    h = torch.where(h > 0, h, LEAKY_SLOPE * h)
            outs.append(h.T)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
