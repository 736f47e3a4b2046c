"""Input encodings: the tcnn-layout multiresolution hash grid and degree-4
spherical harmonics.

Port of `neural_renderer_tpu/models/encoding.py` (tcnn grid.h semantics):

  * level scale  s_l = 2^(l*log2(per_level_scale)) * base_resolution - 1
  * resolution   R_l = ceil(s_l) + 1
  * sample pos   p = x*s_l + 0.5; corner = floor(p); w = p - corner
  * indexing     dense (stride accumulation) while R^3 <= hashmap entries,
                 else coherent prime hash {1, 2654435761, 805459861}, both
                 in wrapping uint32 arithmetic, then % entries
  * per-level table [entries, features], entries min(R^3, 2^log2) padded
    to 8, features interleaved per entry
  * trilinear interpolation of 8 corners, added in dz, dy, dx order
  * output level-major: [L0f0..L0f3, L1f0.., ...]

PyTorch has no uint32 arithmetic, so the indices are int64 holding the
uint32 value: each operand is masked to 32 bits (a corner at -1 becomes
2^32 - 1, as JAX's `astype(uint32)` makes it), and each product is formed
from 16-bit halves of the constant so that no int64 product overflows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 8
    n_features: int = 4
    log2_hashmap_size: int = 14
    base_resolution: int = 16
    per_level_scale: float = 2.0

    def level_scale(self, level: int) -> float:
        return (2.0 ** (level * math.log2(self.per_level_scale))
                * self.base_resolution - 1.0)

    def level_resolution(self, level: int) -> int:
        return int(math.ceil(self.level_scale(level))) + 1

    def level_entries(self, level: int) -> int:
        """Table entries for one level (dense volume or hashmap), padded to 8."""
        res = self.level_resolution(level)
        hashmap = 1 << self.log2_hashmap_size
        dense = res ** 3
        n = dense if dense <= hashmap else hashmap
        return ((n + 7) // 8) * 8

    def level_is_dense(self, level: int) -> bool:
        # tcnn hashes when the dense stride overflows the hashmap size.
        return self.level_resolution(level) ** 3 <= \
            (1 << self.log2_hashmap_size)

    @property
    def n_params(self) -> int:
        return sum(self.level_entries(lv)
                   for lv in range(self.n_levels)) * self.n_features

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features


def init_hashgrid(config: HashGridConfig, generator: torch.Generator,
                  device="cuda"):
    """tcnn default init, uniform(-1e-4, 1e-4), drawn from `generator` on
    the CPU. Returns a list of [E_l, F] f32 tables on `device`."""
    tables = []
    for level in range(config.n_levels):
        t = torch.rand((config.level_entries(level), config.n_features),
                       generator=generator, dtype=torch.float32)
        tables.append((t * 2e-4 - 1e-4).to(device))
    return tables


def _mul32(u, c: int):
    """(u * c) mod 2^32 for int64 u in [0, 2^32) and a constant c < 2^32,
    from c's 16-bit halves: no intermediate exceeds 2^49."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((u * hi) & 0xFFFF) << 16) + u * lo) & _MASK32


def _corner_index(cfg: HashGridConfig, level: int, ix, iy, iz):
    """Grid entry index (int64) for integer corner coords (tcnn
    grid_index), with the uint32 wrap of the reference."""
    res = cfg.level_resolution(level)
    ux, uy, uz = ix & _MASK32, iy & _MASK32, iz & _MASK32
    if cfg.level_is_dense(level):
        idx = (ux + _mul32(uy, res) + _mul32(uz, res * res)) & _MASK32
    else:
        idx = (_mul32(ux, _PRIMES[0]) ^ _mul32(uy, _PRIMES[1])
               ^ _mul32(uz, _PRIMES[2]))
    return idx % cfg.level_entries(level)


def hashgrid_encode_features(tables, x, config: HashGridConfig):
    """x: [3, N] in [0, 1]. Returns a list of L*F feature tensors [N]
    (level-major, feature order within level). The eight corners of a level
    are gathered at once, feature-major as the reference gathers ([F, 8,
    N] from the [F, E] transposed table; PyTorch's row gather of [8, N, F]
    is many times slower on the H100, PERF.md), and added one by one in the
    reference's dz, dy, dx order."""
    outs = []
    for level in range(config.n_levels):
        scale = torch.tensor(config.level_scale(level), dtype=torch.float32,
                             device=x.device)
        p = x * scale + 0.5
        corner = torch.floor(p)
        w = p - corner
        c0 = corner.to(torch.int64)
        one_m = 1.0 - w
        cx, cy, cz, wcs = [], [], [], []
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    cx.append(c0[0] + dx)
                    cy.append(c0[1] + dy)
                    cz.append(c0[2] + dz)
                    wx = w[0] if dx else one_m[0]
                    wy = w[1] if dy else one_m[1]
                    wz = w[2] if dz else one_m[2]
                    wcs.append(wx * wy * wz)
        idx = _corner_index(config, level, torch.stack(cx), torch.stack(cy),
                            torch.stack(cz))                     # [8, N]
        table_t = tables[level].t().contiguous()                 # [F, E]
        terms = table_t[:, idx] * torch.stack(wcs)[None]         # [F, 8, N]
        acc = terms[:, 0]
        for c in range(1, 8):
            acc = acc + terms[:, c]
        outs.extend(acc[f] for f in range(config.n_features))
    return outs


def hashgrid_encode(tables, x, config: HashGridConfig):
    """x: [3, N] in [0, 1]. Returns [N, L*F] level-major features."""
    return torch.stack(hashgrid_encode_features(tables, x, config), dim=-1)


# ---------------------------------------------------------------------------
# Spherical harmonics (tcnn sh_enc, degree 4 -> 16 coefficients)
# ---------------------------------------------------------------------------

SH_DEGREE = 4
SH_DIM = SH_DEGREE * SH_DEGREE


def sh_encode_features(d01):
    """d01: [3, N] direction mapped to [0, 1]; tcnn maps it back to [-1, 1]
    and evaluates WITHOUT normalizing. Returns a list of 16 tensors [N]."""
    d = d01 * 2.0 - 1.0
    x, y, z = d[0], d[1], d[2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    return [
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
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
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ]
