"""Training data: shell segments with ground-truth mesh intersections.

Port of `neural_renderer_tpu/train/dataset.py`. Random rays through the
shell volume are marched exactly like the renderer, and the ORIGINAL mesh
supplies the supervision: presence, distance from the shifted entry, shading
normal and albedo per segment. The network inputs are built as the renderer
builds them (shifted entry, exit = min of outer exit / inner entry,
midpoint, direction in [0, 1]).

The sampler is split in two: `sample_rays` draws the rays from a
`torch.Generator` (JAX's threefry stream has no torch counterpart), and
`segment_batch_from_rays` does everything after the draw, so a test can feed
it the JAX sampler's own rays.

All vectors are channel-major ([3, B]; network inputs [12, B]).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import traversal
from ..ops.intersect import compute_hit_data, resolve_material
from ..ops.linalg import where3
from ..render.neural_march import SEGMENT_EPSILON

_MISS = 1e30


class SegmentBatch(NamedTuple):
    inputs: torch.Tensor    # [12, B] network inputs (normalized)
    presence: torch.Tensor  # [B] float 0/1
    distance: torch.Tensor  # [B] distance from shifted entry (if presence)
    normal: torch.Tensor    # [3, B] GT shading normal (if presence)
    color: torch.Tensor     # [3, B] GT albedo (if presence)
    valid: torch.Tensor     # [B] bool: the segment exists


def sample_rays(generator: torch.Generator, rays: int, radius: float,
                outer_min, outer_inv_extent):
    """Origins uniform on the sphere of `radius` around the shell,
    directions toward uniform points in the outer box (so most rays cross
    the shell). Drawn on the generator's device; returns (o, d) [3, rays]."""
    dev = generator.device
    o = torch.randn((3, rays), generator=generator, dtype=torch.float32,
                    device=dev)
    o = o / torch.linalg.vector_norm(o, dim=0, keepdim=True) * radius
    u = torch.rand((3, rays), generator=generator, dtype=torch.float32,
                   device=dev)
    target = outer_min[:, None] + u / torch.clamp(outer_inv_extent[:, None],
                                                  min=1e-12)
    d = target - o
    d = d / torch.linalg.vector_norm(d, dim=0, keepdim=True)
    return o, d


def sample_segment_batch(generator: torch.Generator, gt_mesh, outer, inner,
                         outer_min, outer_inv_extent, batch_size: int,
                         radius: float, segments_per_ray: int = 1,
                         global_row=None, sweep: bool = True) -> SegmentBatch:
    """One batch of supervised shell segments: ceil(batch_size /
    segments_per_ray) rays from `sample_rays`, marched by
    `segment_batch_from_rays`. outer_min / outer_inv_extent: [3] f32."""
    s = max(1, int(segments_per_ray))
    o, d = sample_rays(generator, -(-batch_size // s), radius, outer_min,
                       outer_inv_extent)
    return segment_batch_from_rays(o, d, gt_mesh, outer, inner, outer_min,
                                   outer_inv_extent, batch_size, s,
                                   global_row=global_row, sweep=sweep)


def segment_batch_from_rays(o, d, gt_mesh, outer, inner, outer_min,
                            outer_inv_extent, batch_size: int,
                            segments_per_ray: int = 1, global_row=None,
                            sweep: bool = True) -> SegmentBatch:
    """March [3, R] rays through up to `segments_per_ray` shell segments
    and emit every segment as a training row; rows of exhausted rays are
    invalid. Returns batch_size rows (the segments concatenated row block by
    row block, then cut).

    sweep=True: per segment ONE fused dual-shell sweep replaces the outer
    backward, inner and re-entry traces (crossings of a closed surface
    alternate, so from the shifted entry the first backward outer crossing
    is the exit and the first forward one the re-entry); the first sweep
    runs from the origin with the second forward crossing. sweep=False keeps
    the literal traces (the oracle)."""
    s = max(1, int(segments_per_ray))
    dev = o.device
    # One octant/morton sort for the whole batch (row order does not matter
    # to the loss): every ground-truth trace then skips its own sort.
    order = traversal._ray_sort_order(o, d, None)
    o, d = o[:, order], d[:, order]
    rays = o.shape[1]

    if global_row is None:
        from ..scene.materials import Material
        global_row = torch.as_tensor(Material.default().scalar_row(),
                                     device=dev)
    omin = outer_min[:, None]
    inv = outer_inv_extent[:, None]
    zero3 = torch.zeros((3, rays), dtype=torch.float32, device=dev)

    if sweep:
        sw0 = traversal.sweep_shells(outer, inner, o, d, with_fwd2=(s > 1))
        valid = sw0.outer_fwd < _MISS
        entry_t0 = torch.where(valid, sw0.outer_fwd, 0.0)
        entry_pos = o + d * entry_t0[None, :]
        entry_abs = entry_t0
    else:
        res_entry = traversal.trace_mesh(outer, o, d, traversal.FORWARD_ONLY)
        valid = res_entry.hit
        entry_pos = o + d * res_entry.t[None, :]

    rows = []
    re_t = None
    for it in range(s):
        shifted_entry = entry_pos + d * SEGMENT_EPSILON

        if sweep and it == 0:
            base = entry_t0 + SEGMENT_EPSILON
            inner_abs = torch.minimum(sw0.inner_fwd, sw0.inner_bwd)
            inner_hit = inner_abs < _MISS
            inner_t = torch.where(
                inner_hit, torch.clamp(inner_abs - base, min=0.0), _MISS)
            exit_t = torch.where(sw0.outer_bwd < _MISS,
                                 torch.clamp(sw0.outer_bwd - base, min=0.0),
                                 SEGMENT_EPSILON)
            re_t = torch.where(sw0.outer_fwd2 < _MISS,
                               sw0.outer_fwd2 - base, _MISS)
            # Ground truth from the SHIFTED entry, as the oracle traces it.
            res_gt0 = traversal.trace_mesh(gt_mesh, shifted_entry, d,
                                           traversal.ANY, active=valid,
                                           presorted=True)
            gt_abs = torch.where(res_gt0.hit, base + res_gt0.t, _MISS)
            gt_hit_c = res_gt0.hit
            gt_tri_c, gt_u_c, gt_v_c = res_gt0.tri, res_gt0.u, res_gt0.v
            gt_hit = gt_hit_c
            gt_t = torch.clamp(gt_abs - base, min=0.0)
            gt_tri, gt_u, gt_v = gt_tri_c, gt_u_c, gt_v_c
        elif sweep:
            sw = traversal.sweep_shells(outer, inner, shifted_entry, d)
            inner_t = torch.minimum(sw.inner_fwd, sw.inner_bwd)
            inner_hit = inner_t < _MISS
            exit_t = torch.where(sw.outer_bwd < _MISS, sw.outer_bwd,
                                 SEGMENT_EPSILON)
            re_t = sw.outer_fwd  # relative to shifted_entry
            base = entry_abs + SEGMENT_EPSILON
            # Re-trace the ground truth for rays whose carried hit was
            # consumed by the previous row or now lies before the new entry
            # (a GT surface need not lie inside the coarse shell volume).
            stale = gt_hit_c & (gt_abs < base - SEGMENT_EPSILON)
            refresh = gt_consumed | stale
            res_gt = traversal.trace_mesh(gt_mesh, shifted_entry, d,
                                          traversal.ANY,
                                          active=valid & refresh,
                                          presorted=True)
            gt_abs = torch.where(
                refresh, torch.where(res_gt.hit, base + res_gt.t, _MISS),
                gt_abs)
            gt_hit_c = torch.where(refresh, res_gt.hit, gt_hit_c)
            gt_tri_c = torch.where(refresh, res_gt.tri, gt_tri_c)
            gt_u_c = torch.where(refresh, res_gt.u, gt_u_c)
            gt_v_c = torch.where(refresh, res_gt.v, gt_v_c)
            gt_hit = gt_hit_c
            gt_t = torch.clamp(gt_abs - base, min=0.0)
            gt_tri, gt_u, gt_v = gt_tri_c, gt_u_c, gt_v_c
        else:
            res_exit = traversal.trace_mesh(outer, shifted_entry, d,
                                            traversal.BACKWARD_ONLY,
                                            active=valid)
            exit_t = torch.where(res_exit.hit, res_exit.t, SEGMENT_EPSILON)
            res_inner = traversal.trace_mesh(inner, shifted_entry, d,
                                             traversal.ANY, active=valid)
            inner_hit = res_inner.hit
            inner_t = torch.where(res_inner.hit, res_inner.t, _MISS)
            res_gt = traversal.trace_mesh(gt_mesh, shifted_entry, d,
                                          traversal.ANY, active=valid,
                                          presorted=True)
            gt_hit, gt_t = res_gt.hit, res_gt.t
            gt_tri, gt_u, gt_v = res_gt.tri, res_gt.u, res_gt.v
        seg_t = torch.where(inner_hit & (inner_t < exit_t), inner_t, exit_t)
        exit_pos = shifted_entry + d * seg_t[None, :]

        # Inside the segment: the closest GT hit lands before its end.
        inside = gt_hit & (gt_t <= seg_t + SEGMENT_EPSILON)
        presence = (valid & inside).to(torch.float32)
        if sweep:
            gt_consumed = inside  # the next segment must look past this hit

        hd = compute_hit_data(gt_mesh, shifted_entry, d, gt_tri, gt_u, gt_v,
                              gt_t)
        rm = resolve_material(gt_mesh, hd.material_id, hd.uv, global_row)

        norm_entry = (shifted_entry - omin) * inv
        norm_exit = (exit_pos - omin) * inv
        mid = 0.5 * (shifted_entry + exit_pos)
        norm_mid = (mid - omin) * inv
        dir01 = (d + 1.0) * 0.5
        rows.append(SegmentBatch(
            inputs=torch.cat([norm_entry, norm_exit, norm_mid, dir01], dim=0),
            presence=presence,
            distance=torch.where(inside, gt_t, 0.0),
            normal=where3(inside, hd.shading_normal, zero3),
            color=where3(inside, rm.base_color, zero3),
            valid=valid,
        ))

        if it + 1 < s:
            # Advance through the re-entry: the first FORWARD outer crossing
            # beyond the epsilon-shifted exit.
            if sweep:
                hit_re = re_t > seg_t + SEGMENT_EPSILON
                valid = valid & (re_t < _MISS) & hit_re
                entry_pos = shifted_entry + d * re_t[None, :]
                entry_abs = entry_abs + SEGMENT_EPSILON + re_t
            else:
                shifted_exit = exit_pos + d * SEGMENT_EPSILON
                res_re = traversal.trace_mesh(outer, shifted_exit, d,
                                              traversal.FORWARD_ONLY,
                                              active=valid)
                valid = valid & res_re.hit
                entry_pos = shifted_exit + d * res_re.t[None, :]

    if s == 1:
        return rows[0]
    return SegmentBatch(*(torch.cat(xs, dim=-1)[..., :batch_size]
                          for xs in zip(*rows)))
