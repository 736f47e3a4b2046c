"""Lane-local multiresolution hash grid, forward only.

Port of `neural_renderer_tpu/models/lane_grid.py`: `level_scale`,
`hash_corner`, `init_lane_tables` and `lane_encode_features` (with
`level_corners`, which the training backward's twin shares). Each
(point, level, feature) owns a table of S x pack x 128 entries; the flat
entry index is sub * (pack * 128) + half * 128 + lane, the row-major
flatten of the trailing table axes. Hash: tcnn's coherent prime xor
{1, 2654435761, 805459861}, masked to the table size.
"""

from __future__ import annotations

import math

import torch

PRIME_X = 1
PRIME_Y = 2654435761
PRIME_Z = 805459861
LANES = 128


def level_scale(level: int, base_resolution: int,
                per_level_scale: float) -> float:
    """tcnn grid scale: 2^(l*log2(pls)) * base - 1."""
    return (2.0 ** (level * math.log2(per_level_scale))
            * base_resolution - 1.0)


def hash_corner(cx, cy, cz, n_entries: int):
    """Integer corner coords -> table index in [0, n_entries) (a power of
    two). Computed in int64: only the low bits survive the mask, and they
    equal those of the reference's wrapping uint32 arithmetic."""
    h = (cx.to(torch.int64) * PRIME_X) ^ (cy.to(torch.int64) * PRIME_Y) \
        ^ (cz.to(torch.int64) * PRIME_Z)
    return h & (n_entries - 1)


def init_lane_tables(n_points: int, n_levels: int, n_features: int,
                     sublanes: int, entry_pack: int,
                     generator: torch.Generator, device="cuda"):
    """Uniform(-1e-4, 1e-4) like tcnn's grid init. [P, L, F, S, 128] for
    entry_pack=1, [P, L, F, S, 2, 128] for entry_pack=2."""
    shape = ((n_points, n_levels, n_features, sublanes, LANES)
             if entry_pack == 1 else
             (n_points, n_levels, n_features, sublanes, entry_pack, LANES))
    t = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (t * 2e-4 - 1e-4).to(device)


def level_corners(x, level: int, base_resolution: int,
                  per_level_scale: float, n_entries: int):
    """The 8 trilinear corners of points x [3, N] at one level: a list of
    (table index [N] int64, weight [N] f32) in corner order dx + 2 dy +
    4 dz."""
    scale = torch.tensor(level_scale(level, base_resolution,
                                     per_level_scale),
                         dtype=torch.float32, device=x.device)
    p = x * scale + 0.5
    corner = torch.floor(p)
    w = p - corner
    c0 = corner.to(torch.int64)
    out = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx = hash_corner(c0[0] + dx, c0[1] + dy, c0[2] + dz,
                                  n_entries)
                wx = w[0] if dx else (1.0 - w[0])
                wy = w[1] if dy else (1.0 - w[1])
                wz = w[2] if dz else (1.0 - w[2])
                out.append((idx, wx * wy * wz))
    return out


def lane_encode_point_features(tables_p, x, base_resolution: int,
                               per_level_scale: float):
    """Encode one point. tables_p: [L, F, S, (pack,) 128]; x: [3, N].
    Returns L*F tensors [N] (level-major, feature within level)."""
    n_levels, n_features = tables_p.shape[:2]
    n_entries = math.prod(tables_p.shape[2:])
    outs = []
    for level in range(n_levels):
        table_fe = tables_p[level].reshape(n_features, n_entries)
        acc = None
        for idx, wc in level_corners(x, level, base_resolution,
                                     per_level_scale, n_entries):
            term = table_fe[:, idx] * wc[None, :]
            acc = term if acc is None else acc + term
        outs.extend(acc[f] for f in range(n_features))
    return outs


def lane_encode_features(tables, inputs, base_resolution: int,
                         per_level_scale: float):
    """All points. tables: [P, L, F, S, (pack,) 128]; inputs: [3P(+...), N]
    channel-major, point p at rows [3p, 3p+3). Returns P*L*F tensors [N]."""
    feats = []
    for p in range(tables.shape[0]):
        feats.extend(lane_encode_point_features(
            tables[p], inputs[3 * p:3 * p + 3], base_resolution,
            per_level_scale))
    return feats
