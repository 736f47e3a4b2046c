"""Neural-branch frame: shell-march primary, the hybrid additional mesh,
and the wavefront bounce loop.

Port of `neural_renderer_tpu/render/neural_frame.py`: `render_neural_frame`
(with the denoiser's guide buffers on request), `_bounce_stage_compacted`
and `render_neural_lambert`:
  1. multi-segment shell march for camera rays; with the hybrid branch, the
     additional mesh traced FORWARD_ONLY and the nearer hit kept;
  2. bounces: Disney sample -> early termination + shell entry (one sweep)
     -> shell march on the compacted, spatially sorted active rays (and the
     additional mesh traced ANY on them, merged) -> environment
     integration;
  3. finalize with running accumulation.
The Lambert view is step 1 followed by `pathtrace.lambert_shade`.
"""

from __future__ import annotations

import torch

from ..ops import traversal
from ..ops.linalg import where3
from ..utils import spans
from . import pathtrace as pt
from .neural_march import (_COMPACT_MIN_RAYS, NeuralContext, _material_rows,
                           bounce_shell_entry_and_early_term,
                           trace_neural_segments)


def _bounce_stage(ctx, params, additional, rays: "pt.BounceRays", active):
    """Early termination + shell entry (one fused sweep) + shell march, on
    any batch width; with an `additional` mesh (else None) its ANY trace of
    the rays with pdf > 0, merged by distance."""
    with spans.span("earlyTermination"):
        active, entry = bounce_shell_entry_and_early_term(ctx, rays, active)
    with spans.span("shellTrace"):
        hits = trace_neural_segments(ctx, params, rays.origin,
                                     rays.direction, entry=entry)
    if additional is not None:
        with spans.span("additionalMeshBounce"):
            add_hits = pt.trace_rays_mesh(additional, params, rays.origin,
                                          rays.direction, traversal.ANY,
                                          active=rays.pdf > 0.0)
        with spans.span("selectClosestBounce"):
            hits = pt.select_closest_hits(params, hits, add_hits,
                                          rays.origin)
    return hits, active


def _bounce_stage_compacted(ctx, params, additional, rays, path_active,
                            compaction: bool | None = None):
    """The bounce stage on the active rays only, gathered and ordered by
    `_ray_sort_order` (direction octant | origin morton | direction
    morton) so the shell sweeps see tight 512-ray frusta; results are
    scattered back. Per-ray math is batch-position independent, so this
    equals the full-batch stage. The gather and the scatter are the
    `compactBounce` stage."""
    n = rays.origin.shape[1]
    dev = rays.origin.device
    mask = path_active & (rays.pdf > 0.0)
    use = (n >= _COMPACT_MIN_RAYS) if compaction is None else bool(compaction)
    if not use:
        return _bounce_stage(ctx, params, additional, rays, mask)

    with spans.span("compactBounce"):
        zero3 = torch.zeros((3, n), dtype=torch.float32, device=dev)
        with spans.span("sync.bounceCompact"):
            idx0 = torch.nonzero(mask).squeeze(1)
        k = idx0.shape[0]
        if k == 0:
            miss = pt.HitState(
                position=zero3, normal=zero3, albedo=zero3,
                material_params=zero3,
                hit=torch.zeros(n, dtype=torch.bool, device=dev),
                distance=torch.zeros(n, device=dev))
            return miss, torch.zeros(n, dtype=torch.bool, device=dev)

        order = traversal._ray_sort_order(rays.origin[:, idx0],
                                          rays.direction[:, idx0])
        idx = idx0[order]
        rays_k = pt.BounceRays(
            origin=rays.origin[:, idx], direction=rays.direction[:, idx],
            pdf=rays.pdf[idx],
            # brdf_weight is read only by the full-batch integrator.
            brdf_weight=torch.zeros((3, k), dtype=torch.float32, device=dev),
            distance=rays.distance[idx])
    hits_k, act_k = _bounce_stage(
        ctx, params, additional, rays_k,
        torch.ones(k, dtype=torch.bool, device=dev))

    def srow(vals):
        out = torch.zeros((*vals.shape[:-1], n), dtype=vals.dtype, device=dev)
        out[..., idx] = vals
        return out

    with spans.span("compactBounce"):
        hit_full = srow(hits_k.hit)
        if additional is None:
            # Every march hit carries the same global-material row.
            material_params = where3(hit_full,
                                     _material_rows(params, n, dev), zero3)
        else:
            # A hit of the additional mesh carries its own material's.
            material_params = srow(hits_k.material_params)
        hits = pt.HitState(
            position=srow(hits_k.position), normal=srow(hits_k.normal),
            albedo=srow(hits_k.albedo), material_params=material_params,
            hit=hit_full, distance=srow(hits_k.distance))
        return hits, srow(act_k)


def _additional(use_additional, additional_mesh):
    """The additional mesh to trace, or None."""
    if use_additional and additional_mesh is None:
        raise ValueError("use_additional needs the additional_mesh")
    return additional_mesh if (
        use_additional and not additional_mesh.is_empty) else None


def _camera_hits(ctx: NeuralContext, params, origins, dirs, additional):
    """Camera-ray hits: the shell march and, with an `additional` mesh,
    its FORWARD_ONLY trace merged by distance."""
    with spans.span("shellTrace"):
        hits = trace_neural_segments(ctx, params, origins, dirs)
    if additional is not None:
        with spans.span("additionalMeshPrimary"):
            add_hits = pt.trace_rays_mesh(additional, params, origins, dirs,
                                          traversal.FORWARD_ONLY)
        with spans.span("selectClosestPrimary"):
            hits = pt.select_closest_hits(params, hits, add_hits, origins)
    return hits


def render_neural_frame(ctx: NeuralContext, env, params, accum,
                        use_additional: bool = False,
                        bounce_compaction: bool | None = None,
                        additional_mesh=None, return_guides: bool = False,
                        row0: int = 0, n_rows: int | None = None):
    """One accumulation batch of neural path tracing. Returns
    (image_u8 [H, W, 3], new_accum [3, H*W])[, (guide_normals,
    guide_albedo)]: the guides are the merged camera hits'.
    use_additional traces `additional_mesh` (MeshTensors) beside the
    shells, where it is not empty. row0 / n_rows render a horizontal stripe
    with global pixel ids (parallel/shardings.py); accum and the outputs
    then cover that stripe."""
    additional = _additional(use_additional, additional_mesh)
    with spans.span("primaryRays"):
        pixel_idx, sample_of, _, origins, dirs = pt.primary_rays(
            params, row0, n_rows)
    hits = _camera_hits(ctx, params, origins, dirs, additional)
    with spans.span("initPathState"):
        path = pt.init_path_state(params, env, hits, dirs)

    incoming = None
    cur_hits = hits
    for bounce in range(1, params.max_bounces + 1):
        # Once no path is active a bounce is an exact identity on the path
        # state (active only shrinks; integration writes under masks).
        if incoming is not None and not pt.any_active(path):
            break
        with spans.span("sampleBounce"):
            rays, active = pt.sample_bounce(params, pixel_idx, sample_of,
                                            cur_hits, path.active, incoming)
            path = path._replace(active=active)
        bounce_hits, active = _bounce_stage_compacted(
            ctx, params, additional, rays, path.active,
            compaction=bounce_compaction)
        path = path._replace(active=active)
        with spans.span("integrateBounce"):
            path = pt.integrate_bounce(params, env, path, bounce_hits, rays,
                                       bounce, pixel_idx, sample_of)
        incoming, cur_hits = rays.direction, bounce_hits

    with spans.span("finalize"):
        img, new_accum = pt.finalize(params, path.radiance, accum)
    if return_guides:
        return img, new_accum, pt.guide_buffers(params, hits, n_rows)
    return img, new_accum


def render_neural_lambert(ctx: NeuralContext, env, params,
                          use_additional: bool = False,
                          additional_mesh=None):
    """The neural branch's Lambert view (no bounces): the camera hits
    shaded N.V, the environment on a miss. Returns the u8 image
    [H, W, 3]."""
    _, _, _, origins, dirs = pt.primary_rays(params)
    hits = _camera_hits(ctx, params, origins, dirs,
                       _additional(use_additional, additional_mesh))
    return pt.lambert_shade(params, env, hits, dirs)
