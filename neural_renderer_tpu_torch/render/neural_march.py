"""Multi-segment shell march: the neural intersection query.

Port of `neural_renderer_tpu/render/neural_march.py`: `NeuralContext`,
`trace_neural_segments`, `bounce_shell_entry_and_early_term`, the shell
entries `_shell_entry_camera` and `_shell_entry_from_rays`, the bad-ray
fix-ups and at most MAX_SEGMENT_ITERATIONS iterations. Two strategies are
chosen per call or, by default, from the environment at import, as the JAX
package reads them:
  * the camera entry, NR_CAMERA_ENTRY: "fwd2" (default; one dual-shell
    sweep with the strict second outer-forward crossing serves both the
    shell entry and iteration 1) or "trace" (a FORWARD_ONLY trace of the
    outer shell, then iteration 1 through the compaction like any other);
  * the re-entry of rays that start inside the outer shell,
    NR_ENTRY_RETRY: "derive" (default; no retry trace: the sweep from the
    origin already saw every forward crossing) or "trace" (the
    reference-shaped exit-then-retry trace, the oracle "derive" is held
    to).

Compaction uses dynamic shapes (`torch.nonzero`) where the JAX package
compacts into fixed capacities under `lax.cond`; per-ray math does not
depend on a ray's batch position, so the result equals the full batch.

Stages of one iteration: segment exits from the shell sweep, normalized
network inputs [entry | exit | mid | dir01], the fused network, output
application, re-entry from the sweep's outer_fwd.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..models import nbvh
from ..ops import traversal
from ..ops.linalg import safe_normalize, splat, where3
from ..scene.materials import P_METALLIC, P_ROUGHNESS, P_SPECULAR
from ..utils import spans
from .pathtrace import HitState

MAX_SEGMENT_ITERATIONS = 10
SEGMENT_EPSILON = 1e-8
_COMPACT_MIN_RAYS = 4096
CAMERA_ENTRY_DEFAULT = os.environ.get("NR_CAMERA_ENTRY", "fwd2")
ENTRY_RETRY_DEFAULT = os.environ.get("NR_ENTRY_RETRY", "derive")


@dataclass
class NeuralContext:
    """Everything the shell march needs: shell meshes + the network."""
    outer: object   # MeshTensors
    inner: object   # MeshTensors
    net: nbvh.ShellNetwork


def _material_rows(params, n, device):
    row = params.material_row
    return torch.stack([row[P_METALLIC].expand(n), row[P_ROUGHNESS].expand(n),
                        row[P_SPECULAR].expand(n)], dim=0)


def _scatter(dst, idx, vals):
    """dst with dst[..., idx] = vals (a new tensor)."""
    out = dst.clone()
    out[..., idx] = vals
    return out


def segment_inputs(ctx, params, dirs_b, entry_b, active_b, sw=None):
    """Segment exits and network inputs of one march iteration over a ray
    batch [*, K]. Returns (net_in [12, K], sw, shifted_entry, exit_t,
    inner_hit, inner_t, inner_before, seg_t, exit_pos). `sw` optionally
    supplies the iteration's shell sweep (t's from the shifted entry)."""
    k = dirs_b.shape[1]
    big = torch.full((k,), traversal.MISS, device=dirs_b.device)
    outer_min = params.outer_shell_min[:, None]
    inv_extent = params.outer_shell_inv_extent[:, None]

    shifted_entry = entry_b + dirs_b * SEGMENT_EPSILON
    if sw is None:
        sw = traversal.sweep_shells(ctx.outer, ctx.inner, shifted_entry,
                                    dirs_b)
    exit_hit = active_b & (sw.outer_bwd < 1e30)
    exit_t = torch.where(exit_hit, sw.outer_bwd,
                         torch.full_like(big, SEGMENT_EPSILON))
    inner_any = torch.minimum(sw.inner_fwd, sw.inner_bwd)
    inner_hit = active_b & (inner_any < 1e30)
    inner_t = torch.where(inner_hit, inner_any, big)
    inner_before = inner_hit & (inner_t < exit_t)
    seg_t = torch.where(inner_before, inner_t, exit_t)
    exit_pos = shifted_entry + dirs_b * seg_t[None, :]

    norm_entry = (shifted_entry - outer_min) * inv_extent
    norm_exit = (exit_pos - outer_min) * inv_extent
    mid = 0.5 * (shifted_entry + exit_pos)
    norm_mid = (mid - outer_min) * inv_extent
    dir01 = (dirs_b + 1.0) * 0.5
    net_in = torch.cat([norm_entry, norm_exit, norm_mid, dir01], dim=0)
    return (net_in, sw, shifted_entry, exit_t, inner_hit, inner_t,
            inner_before, seg_t, exit_pos)


def _segment_step(ctx, params, dirs_b, entry_b, active_b, accum_b, sw=None):
    """One march iteration over a ray batch [*, K]. Returns (found, hit_pos,
    normal, color, distance, new_active, new_entry, new_accum)."""
    k = dirs_b.shape[1]
    dev = dirs_b.device
    big = torch.full((k,), traversal.MISS, device=dev)
    (net_in, sw, shifted_entry, exit_t, inner_hit, inner_t, inner_before,
     seg_t, exit_pos) = segment_inputs(ctx, params, dirs_b, entry_b,
                                       active_b, sw)

    outputs = nbvh.apply(ctx.net, net_in, active=active_b)   # [16, K]
    presence = outputs[0]
    distance = outputs[1]
    normal_raw = outputs[2:5]
    color_raw = torch.clamp(outputs[5:8], 0.0, 1.0)

    found = active_b & ((presence >= 0.0) | inner_before)
    clamped = torch.where(inner_t > 0.0,
                          torch.minimum(distance, inner_t - SEGMENT_EPSILON),
                          distance)
    hit_pos = shifted_entry + dirs_b * clamped[None, :]
    normal = safe_normalize(normal_raw, min_len=1e-6)
    if params.use_constant_neural_color:
        color = splat(params.constant_neural_color, k, dev)
    else:
        color = color_raw

    # Re-entry: crossings of a closed surface alternate, so sw.outer_fwd is
    # the next entry; rays where it lands inside the segment (non-manifold
    # or FP-grazing geometry) are re-traced exactly.
    still = active_b & ~found
    shifted_exit = exit_pos + dirs_b * SEGMENT_EPSILON
    t_from_exit = sw.outer_fwd - (seg_t + SEGMENT_EPSILON)
    re_hit = (sw.outer_fwd < 1e30) & (t_from_exit > traversal.MIN_T)
    bad = still & (sw.outer_fwd < 1e30) & ~re_hit
    with spans.span("sync.marchReentry"):
        bidx = torch.nonzero(bad).squeeze(1)
    if bidx.numel() > 0:
        res = traversal.trace_mesh(ctx.outer, shifted_exit[:, bidx],
                                   dirs_b[:, bidx], traversal.FORWARD_ONLY)
        re_hit = _scatter(re_hit, bidx, res.hit)
        t_from_exit = _scatter(t_from_exit, bidx, res.t)

    can_continue = still & (re_hit | inner_hit)
    reentry_t = torch.where(re_hit, t_from_exit, torch.zeros_like(big))
    new_entry = shifted_exit + dirs_b * reentry_t[None, :]
    new_entry = where3(can_continue, new_entry, entry_b)
    new_accum = torch.where(
        can_continue, accum_b + exit_t + reentry_t + 2.0 * SEGMENT_EPSILON,
        accum_b)
    return (found, hit_pos, normal, color, distance, can_continue,
            new_entry, new_accum)


def _camera_fwd2_entry(ctx, origins, dirs):
    """Camera fast path: ONE sweep from the camera serves the shell entry
    (outer_fwd) AND iteration 1's segment sweep, offset by entry_t + eps.
    Rays whose first crossing of some facing lies at/inside the entry are
    re-swept exactly. Returns (entry_pos, active, accum_t, sweep_1)."""
    sw0 = traversal.sweep_shells(ctx.outer, ctx.inner, origins, dirs,
                                 with_fwd2=True)
    entry_t = sw0.outer_fwd
    active = entry_t < 1e30
    entry_pos = where3(active, origins + dirs * entry_t[None, :],
                       torch.zeros_like(origins))
    accum_t = torch.where(active, entry_t, torch.zeros_like(entry_t))
    base = entry_t + SEGMENT_EPSILON
    miss = torch.full_like(entry_t, traversal.MISS)

    def derive(t0):
        tt = t0 - base
        return torch.where((t0 < 1e30) & (tt > traversal.MIN_T), tt, miss)

    def dropped(t0):
        return (t0 < 1e30) & (t0 - base <= traversal.MIN_T)

    sw1 = traversal.ShellSweep(
        outer_fwd=derive(sw0.outer_fwd2), outer_bwd=derive(sw0.outer_bwd),
        inner_fwd=derive(sw0.inner_fwd), inner_bwd=derive(sw0.inner_bwd),
        outer_fwd2=miss)
    bad = active & (dropped(sw0.outer_bwd) | dropped(sw0.inner_fwd)
                    | dropped(sw0.inner_bwd) | dropped(sw0.outer_fwd2))
    with spans.span("sync.cameraEntry"):
        bidx = torch.nonzero(bad).squeeze(1)
    if bidx.numel() > 0:
        d_b = dirs[:, bidx]
        o_b = entry_pos[:, bidx] + d_b * SEGMENT_EPSILON
        swb = traversal.sweep_shells(ctx.outer, ctx.inner, o_b, d_b)
        sw1 = traversal.ShellSweep(
            outer_fwd=_scatter(sw1.outer_fwd, bidx, swb.outer_fwd),
            outer_bwd=_scatter(sw1.outer_bwd, bidx, swb.outer_bwd),
            inner_fwd=_scatter(sw1.inner_fwd, bidx, swb.inner_fwd),
            inner_bwd=_scatter(sw1.inner_bwd, bidx, swb.inner_bwd),
            outer_fwd2=sw1.outer_fwd2)
    return entry_pos, active, accum_t, sw1


def _shell_entry_camera(outer, origins, dirs):
    """The camera rays' shell entry by a FORWARD_ONLY trace of the outer
    shell. Returns (entry_pos, active, accum_t)."""
    res = traversal.trace_mesh(outer, origins, dirs, traversal.FORWARD_ONLY)
    active = res.hit
    entry_pos = where3(active, origins + dirs * res.t[None, :],
                       torch.zeros_like(origins))
    accum_t = torch.where(active, res.t, torch.zeros_like(res.t))
    return entry_pos, active, accum_t


def _shell_entry_from_rays(outer, origins, dirs, ray_active, pdfs,
                           retry: str | None = None):
    """The shell entry of arbitrary rays (those with ray_active and pdf >
    0): the closest FORWARD_ONLY crossing of the outer shell. Under
    retry="trace" a ray without one that starts inside the outer shell
    first exits (BACKWARD_ONLY) and re-enters by a trace from just past its
    exit; under the default "derive" that retry is skipped, as it can find
    nothing the origin's trace missed. Returns (entry_pos, hit, accum_t)."""
    retry = ENTRY_RETRY_DEFAULT if retry is None else retry
    ok = ray_active & (pdfs > 0.0)
    res_fwd = traversal.trace_mesh(outer, origins, dirs,
                                   traversal.FORWARD_ONLY, active=ok)
    zero = torch.zeros_like(res_fwd.t)
    if retry != "trace":
        hit = ok & res_fwd.hit
        entry_pos = where3(hit, origins + dirs * res_fwd.t[None, :],
                           torch.zeros_like(origins))
        return entry_pos, hit, torch.where(hit, res_fwd.t, zero)
    need_restart = ok & ~res_fwd.hit
    res_back = traversal.trace_mesh(outer, origins, dirs,
                                    traversal.BACKWARD_ONLY,
                                    active=need_restart)
    return _retry_entry(outer, origins, dirs, ok, res_fwd.hit, res_fwd.t,
                        need_restart & res_back.hit, res_back.t)


def _retry_entry(outer, origins, dirs, ok, fwd_hit, fwd_t, restart, bwd_t):
    """The "trace" retry: rays in `restart` re-enter by a FORWARD_ONLY trace
    from SEGMENT_EPSILON past their backward crossing bwd_t; the others keep
    their forward crossing fwd_t (where fwd_hit). Returns (entry_pos, hit,
    accum_t)."""
    zero = torch.zeros_like(fwd_t)
    base_offset = torch.where(restart, bwd_t + SEGMENT_EPSILON, zero)
    shifted_origin = origins + dirs * base_offset[None, :]
    res_retry = traversal.trace_mesh(outer, shifted_origin, dirs,
                                     traversal.FORWARD_ONLY, active=restart)
    hit = ok & (fwd_hit | res_retry.hit)
    entry_t = torch.where(fwd_hit, fwd_t, res_retry.t)
    entry_origin = where3(fwd_hit, origins, shifted_origin)
    entry_pos = entry_origin + dirs * entry_t[None, :]
    total_t = torch.where(fwd_hit, entry_t, base_offset + entry_t)
    return (where3(hit, entry_pos, torch.zeros_like(entry_pos)), hit,
            torch.where(hit, total_t, zero))


def trace_neural_segments(ctx: NeuralContext, params, origins, dirs,
                          entry=None,
                          compaction: bool | None = None,
                          ray_active=None, pdfs=None,
                          camera_rays: bool = True,
                          camera_entry: str | None = None) -> HitState:
    """Full multi-segment march; returns a HitState over [N] rays. `entry`
    supplies (entry_pos, active, accum_t), as the bounce stage does from its
    shell sweep. Without it, camera rays take the `camera_entry` strategy
    (default CAMERA_ENTRY_DEFAULT), and other rays (camera_rays=False,
    gated by ray_active and pdfs) `_shell_entry_from_rays`."""
    n = origins.shape[1]
    dev = origins.device
    camera_entry = CAMERA_ENTRY_DEFAULT if camera_entry is None \
        else camera_entry
    if camera_entry not in ("fwd2", "trace"):
        raise ValueError(f"unknown camera_entry '{camera_entry}'")
    sw_first = None
    if entry is not None:
        entry_pos, active, accum_t = entry
    elif not camera_rays:
        ray_active = torch.ones(n, dtype=torch.bool, device=dev) \
            if ray_active is None else ray_active
        pdfs = torch.ones(n, dtype=torch.float32, device=dev) \
            if pdfs is None else pdfs
        entry_pos, active, accum_t = _shell_entry_from_rays(
            ctx.outer, origins, dirs, ray_active, pdfs)
    elif camera_entry == "trace":
        entry_pos, active, accum_t = _shell_entry_camera(ctx.outer, origins,
                                                         dirs)
    else:
        entry_pos, active, accum_t, sw_first = _camera_fwd2_entry(
            ctx, origins, dirs)

    zero3 = torch.zeros((3, n), dtype=torch.float32, device=dev)
    out = HitState(position=zero3, normal=zero3, albedo=zero3,
                   material_params=zero3,
                   hit=torch.zeros(n, dtype=torch.bool, device=dev),
                   distance=torch.zeros(n, dtype=torch.float32, device=dev))

    def merge_full(out, found, hit_pos, normal, color, distance):
        return HitState(
            position=where3(found, hit_pos, out.position),
            normal=where3(found, normal, out.normal),
            albedo=where3(found, color, out.albedo),
            material_params=out.material_params,
            hit=out.hit | found,
            distance=torch.where(found, distance, out.distance))

    it = 0
    if sw_first is not None:
        # Peeled iteration 1 on the full batch, consuming the derived sweep.
        (found, hit_pos, normal, color, distance, active, entry_pos,
         accum_t) = _segment_step(ctx, params, dirs, entry_pos, active,
                                  accum_t, sw=sw_first)
        out = merge_full(out, found, hit_pos, normal, color, distance)
        it = 1

    use_compaction = (n >= _COMPACT_MIN_RAYS) if compaction is None \
        else bool(compaction)
    while it < MAX_SEGMENT_ITERATIONS:
        with spans.span("sync.marchActive"):
            going = bool(active.any())
        if not going:
            break
        if not use_compaction:
            (found, hit_pos, normal, color, distance, active, entry_pos,
             accum_t) = _segment_step(ctx, params, dirs, entry_pos, active,
                                      accum_t)
            out = merge_full(out, found, hit_pos, normal, color, distance)
        else:
            with spans.span("sync.marchCompact"):
                idx = torch.nonzero(active).squeeze(1)
            valid = torch.ones(idx.shape[0], dtype=torch.bool, device=dev)
            (found, hit_pos, normal, color, distance, new_active, new_entry,
             new_accum) = _segment_step(ctx, params, dirs[:, idx],
                                        entry_pos[:, idx], valid,
                                        accum_t[idx])
            # The rows that found a hit and those that go on, by mask.
            with spans.span("sync.marchScatter"):
                fidx = idx[found]
                f_pos, f_normal = hit_pos[:, found], normal[:, found]
                f_color, f_dist = color[:, found], distance[found]
                cidx = idx[new_active]
                c_entry = new_entry[:, new_active]
                c_accum = new_accum[new_active]
                f_hit = _scatter(out.hit, fidx, True)
            out = HitState(
                position=_scatter(out.position, fidx, f_pos),
                normal=_scatter(out.normal, fidx, f_normal),
                albedo=_scatter(out.albedo, fidx, f_color),
                material_params=out.material_params, hit=f_hit,
                distance=_scatter(out.distance, fidx, f_dist))
            active = _scatter(active, idx, new_active)
            entry_pos = _scatter(entry_pos, cidx, c_entry)
            accum_t = _scatter(accum_t, cidx, c_accum)
        it += 1

    return out._replace(material_params=where3(
        out.hit, _material_rows(params, n, dev), out.material_params))


def bounce_shell_entry_and_early_term(ctx: NeuralContext, rays, path_active,
                                      retry: str | None = None):
    """Fused bounce-stage shell work: early termination (kill a path whose
    bounce ray meets the inner shell before the outer) and the shell entry
    from arbitrary rays share ONE shell sweep. Under the default "derive"
    re-entry (ENTRY_RETRY_DEFAULT) a ray without a forward outer crossing
    stays outside the march; under "trace" one that starts inside the outer
    shell re-enters by a FORWARD_ONLY trace from just past its backward
    crossing. Returns (active, (entry_pos, entry_hit, accum_t))."""
    retry = ENTRY_RETRY_DEFAULT if retry is None else retry
    sw = traversal.sweep_shells(ctx.outer, ctx.inner, rays.origin,
                                rays.direction)
    outer_any = torch.minimum(sw.outer_fwd, sw.outer_bwd)
    inner_any = torch.minimum(sw.inner_fwd, sw.inner_bwd)
    check = path_active & (rays.pdf > 0.0) & (rays.distance > 0.0)
    kill = check & (inner_any < 1e30) & (outer_any < 1e30) & \
        (inner_any < outer_any)
    active = path_active & ~kill

    ok = active & (rays.pdf > 0.0)
    fwd_hit = ok & (sw.outer_fwd < 1e30)
    if retry == "trace":
        restart = ok & ~fwd_hit & (sw.outer_bwd < 1e30)
        return active, _retry_entry(ctx.outer, rays.origin, rays.direction,
                                    ok, fwd_hit, sw.outer_fwd, restart,
                                    sw.outer_bwd)
    entry_pos = where3(fwd_hit,
                       rays.origin + rays.direction * sw.outer_fwd[None, :],
                       torch.zeros_like(rays.origin))
    accum_t = torch.where(fwd_hit, sw.outer_fwd,
                          torch.zeros_like(sw.outer_fwd))
    return active, (entry_pos, fwd_hit, accum_t)
