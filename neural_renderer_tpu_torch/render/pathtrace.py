"""Wavefront path-tracing stages and the ground-truth frame.

Port of `neural_renderer_tpu/render/pathtrace.py`: `HitState`, `PathState`,
`BounceRays`, `sample_grid`, `primary_rays`, `init_path_state`,
`sample_bounce_directions` (the `sampleBounce` stage, `sample_bounce`:
K10 on the GPU, `sample_bounce_twin` in PyTorch), `integrate_bounce`,
`finalize` (shared with the neural frame), `select_closest_hits` (the
hybrid branch's merge), `guide_buffers` (the denoiser's guides) and the
ground-truth branch: `trace_primary_gt`,
`trace_rays_mesh`, `trace_bounces_gt`, `lambert_shade`, `accum_image`,
`render_gt_frame`, `render_gt_lambert`. Samples are flat [N = spp * pixels] with sample_idx =
pixel + s * pixel_count, so the RNG streams match the reference; vectors
are channel-major [3, N].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.brdf import BrdfMaterial, build_tangent_space, disney_eval, \
    disney_sample_3component
from ..ops import sample_bounce as k10
from ..ops import traversal
from ..ops.camera import generate_primary_rays
from ..ops.envlight import sample_environment, sample_environment_clamped
from ..ops.intersect import compute_hit_data, resolve_material
from ..ops.linalg import dot, safe_normalize, splat, where3
from ..ops.rng import init_rng, rand01
from ..ops.srgb import encode_srgb_u8
from ..scene.materials import P_METALLIC, P_ROUGHNESS, P_SPECULAR
from ..utils import spans


class HitState(NamedTuple):
    position: torch.Tensor         # [3, N]
    normal: torch.Tensor           # [3, N]
    albedo: torch.Tensor           # [3, N]
    material_params: torch.Tensor  # [3, N]: metallic, roughness, specular
    hit: torch.Tensor              # [N] bool
    distance: torch.Tensor         # [N]


class PathState(NamedTuple):
    throughput: torch.Tensor  # [3, N]
    radiance: torch.Tensor    # [3, N]
    active: torch.Tensor      # [N] bool


class BounceRays(NamedTuple):
    origin: torch.Tensor       # [3, N]
    direction: torch.Tensor    # [3, N]
    pdf: torch.Tensor          # [N]
    brdf_weight: torch.Tensor  # [3, N]: f * cos / pdf
    distance: torch.Tensor     # [N]


def sample_grid(params, row0: int = 0, n_rows: int | None = None):
    """Flat [N] pixel coords + ids, s-major (sample = pixel + s * pixels).
    row0 / n_rows select a horizontal stripe (pixel-stripe data
    parallelism, parallel/shardings.py); pixel ids stay GLOBAL, so the RNG
    streams equal the whole frame's whatever the tiling."""
    rows = params.height if n_rows is None else int(n_rows)
    p = rows * params.width
    spp = params.samples_per_pixel
    local = torch.arange(p, dtype=torch.int64, device=params.device)
    px = local % params.width
    py = int(row0) + local // params.width
    pix = py * params.width + px
    sample_of = torch.repeat_interleave(
        torch.arange(spp, dtype=torch.int64, device=params.device), p)
    return px.repeat(spp), py.repeat(spp), pix.repeat(spp), sample_of


def primary_rays(params, row0: int = 0, n_rows: int | None = None):
    px, py, pixel_idx, s = sample_grid(params, row0, n_rows)
    state = init_rng(pixel_idx, params.sample_offset, s)
    state, origins, dirs = generate_primary_rays(
        px, py, state, params.cam_pos, params.cam_forward, params.cam_right,
        params.cam_up, params.fov_y, params.width, params.height)
    return pixel_idx, s, state, origins, dirs


def _resolve_hits(mesh, params, origins, dirs, res) -> HitState:
    """Hit data + material of a trace result; misses carry zeros and the
    global material's parameters."""
    hd = compute_hit_data(mesh, origins, dirs, res.tri, res.u, res.v, res.t)
    rm = resolve_material(mesh, hd.material_id, hd.uv, params.material_row)
    hit = res.hit
    n = hit.shape[0]
    zero3 = torch.zeros((3, n), dtype=torch.float32, device=hit.device)
    row = params.material_row
    global_params = torch.stack([row[P_METALLIC].expand(n),
                                 row[P_ROUGHNESS].expand(n),
                                 row[P_SPECULAR].expand(n)], dim=0)
    hit_params = torch.stack([rm.metallic, rm.roughness, rm.specular], dim=0)
    return HitState(
        position=where3(hit, hd.position, zero3),
        normal=where3(hit, hd.shading_normal, zero3),
        albedo=where3(hit, rm.base_color, zero3),
        material_params=where3(hit, hit_params, global_params),
        hit=hit,
        distance=torch.where(hit, res.t, torch.zeros_like(res.t)))


def trace_primary_gt(mesh, params, origins, dirs) -> HitState:
    """Primary rays against the classic mesh, FORWARD_ONLY (backface
    cull)."""
    res = traversal.trace_mesh(mesh, origins, dirs, traversal.FORWARD_ONLY)
    return _resolve_hits(mesh, params, origins, dirs, res)


def trace_rays_mesh(mesh, params, origins, dirs, mode,
                    active=None) -> HitState:
    """Generic mesh trace + material resolution."""
    res = traversal.trace_mesh(mesh, origins, dirs, mode, active=active)
    return _resolve_hits(mesh, params, origins, dirs, res)


def trace_bounces_gt(mesh, params, rays: "BounceRays") -> HitState:
    """Bounce rays against the ground-truth mesh, TraceMode ANY."""
    return trace_rays_mesh(mesh, params, rays.origin, rays.direction,
                           traversal.ANY, active=rays.pdf > 0.0)


def select_closest_hits(params, a: HitState, b: HitState,
                        ray_origins) -> HitState:
    """Merge two hit sets by distance from the ray origin; `a` wins ties."""
    da = a.position - ray_origins
    db = b.position - ray_origins
    dist_a = torch.sqrt(torch.clamp(dot(da, da), min=0.0))
    dist_b = torch.sqrt(torch.clamp(dot(db, db), min=0.0))
    use_b = (b.hit & ~a.hit) | (a.hit & b.hit & (dist_b < dist_a))
    return HitState(
        position=where3(use_b, b.position, a.position),
        normal=where3(use_b, b.normal, a.normal),
        albedo=where3(use_b, b.albedo, a.albedo),
        material_params=where3(use_b, b.material_params, a.material_params),
        hit=a.hit | b.hit,
        distance=torch.where(use_b, dist_b, a.distance))


def init_path_state(params, env, hits: HitState, prim_dirs) -> PathState:
    """initializePathStateKernel."""
    n = hits.hit.shape[0]
    if params.use_direct_env_color:
        env_light = splat(params.direct_env_color, n, prim_dirs.device)
    else:
        env_light = sample_environment_clamped(env, prim_dirs,
                                               params.max_radiance)
    radiance = where3(hits.hit, torch.zeros_like(env_light), env_light)
    throughput = torch.ones((3, n), dtype=torch.float32,
                            device=prim_dirs.device)
    return PathState(throughput=throughput, radiance=radiance,
                     active=hits.hit)


def _surface_material(params, albedo, material_params) -> BrdfMaterial:
    n = albedo.shape[1]
    mat = BrdfMaterial.broadcast_from_row(params.material_row, n)
    return mat._replace(base_color=albedo, metallic=material_params[0],
                        roughness=material_params[1],
                        specular=material_params[2])


def sample_bounce(params, pixel_idx, sample_of, hits: HitState,
                  path_active, incoming_dirs):
    """The `sampleBounce` stage (sampleBounceDirectionsKernel): the bounce
    rays and the paths still active, path_active & hit & (pdf > 0) (the
    JAX package's update_active_after_sampling). CPU tensors run the twin,
    `sample_bounce_twin`; CUDA tensors launch K10 (ops/sample_bounce.py).
    incoming_dirs None on the first bounce."""
    if not hits.hit.is_cuda:
        return sample_bounce_twin(params, pixel_idx, sample_of, hits,
                                  path_active, incoming_dirs)
    origin, direction, pdf, weight, active = k10.sample_bounce(
        params, pixel_idx, sample_of, hits.position, hits.normal,
        hits.albedo, hits.material_params, hits.hit, path_active,
        incoming_dirs)
    return BounceRays(origin=origin, direction=direction, pdf=pdf,
                      brdf_weight=weight, distance=hits.distance), active


def sample_bounce_directions(params, pixel_idx, sample_of, hits: HitState,
                             path_active, incoming_dirs) -> BounceRays:
    """The bounce rays of `sample_bounce`, under the JAX package's name
    (its parity tests call both packages alike)."""
    return sample_bounce(params, pixel_idx, sample_of, hits, path_active,
                         incoming_dirs)[0]


def sample_bounce_twin(params, pixel_idx, sample_of, hits: HitState,
                       path_active, incoming_dirs):
    """K10's twin in PyTorch, on any device: `sample_bounce`'s (rays,
    active). incoming_dirs None on the first bounce: the primary ray is
    regenerated from the same RNG stream (2 draws before u1..u3); later
    bounces use the stored direction and the stream's first 3 draws,
    reproducing the reference's RNG reuse."""
    state = init_rng(pixel_idx, params.sample_offset, sample_of)
    if incoming_dirs is None:
        px = pixel_idx % params.width
        py = pixel_idx // params.width
        state, _, incoming = generate_primary_rays(
            px, py, state, params.cam_pos, params.cam_forward,
            params.cam_right, params.cam_up, params.fov_y, params.width,
            params.height)
    else:
        incoming = incoming_dirs

    normal = safe_normalize(hits.normal, min_len=0.0)
    normal = where3(dot(normal, incoming) > 0.0, -normal, normal)
    wo = -incoming
    tangent, bitangent = build_tangent_space(normal)
    mat = _surface_material(params, hits.albedo, hits.material_params)

    state, u1 = rand01(state)
    state, u2 = rand01(state)
    state, u3 = rand01(state)
    wi, pdf = disney_sample_3component(mat, normal, wo, tangent, bitangent,
                                       u1, u2, u3)
    f = disney_eval(mat, normal, wo, wi, tangent, bitangent)
    cos_theta = torch.abs(dot(normal, wi))
    brdf_weight = f * (cos_theta / torch.where(pdf > 0.0, pdf,
                                               torch.ones_like(pdf)))[None, :]
    finite = torch.isfinite(brdf_weight).all(dim=0)
    valid = hits.hit & path_active & (pdf > 0.0) & finite

    origin = hits.position + normal * (params.scene_scale * 1e-6)
    zero3 = torch.zeros_like(origin)
    rays = BounceRays(
        origin=where3(valid, origin, zero3),
        direction=where3(valid, wi, zero3),
        pdf=torch.where(valid, pdf, torch.zeros_like(pdf)),
        brdf_weight=where3(valid, brdf_weight, zero3),
        distance=hits.distance)
    # The JAX package's update_active_after_sampling.
    return rays, path_active & hits.hit & (rays.pdf > 0.0)


def any_active(path: PathState) -> bool:
    """Whether any path is still active: the bounce loops' host sync."""
    with spans.span("sync.bounceActive"):
        return bool(path.active.any())


def integrate_bounce(params, env, path: PathState, bounce_hits: HitState,
                     rays: BounceRays, bounce_index: int, pixel_idx,
                     sample_of) -> PathState:
    """integrateBounceKernel."""
    active = path.active
    new_tp = path.throughput * rays.brdf_weight
    env_light = sample_environment_clamped(env, rays.direction,
                                           params.max_radiance)
    missed = active & ~bounce_hits.hit
    radiance = where3(missed, path.radiance + new_tp * env_light,
                      path.radiance)
    hit_cont = active & bounce_hits.hit
    if bounce_index >= params.max_bounces:
        tp = where3(active, new_tp, path.throughput)
        return PathState(throughput=tp, radiance=radiance,
                         active=torch.zeros_like(active))
    survival = torch.clamp(new_tp.amax(dim=0), max=1.0)
    rr_state = init_rng(pixel_idx, params.sample_offset + bounce_index,
                        sample_of)
    _, rr = rand01(rr_state)
    still = hit_cont & (rr < survival)
    tp_rr = new_tp / torch.clamp(survival, min=1e-20)[None, :]
    tp = where3(still, tp_rr, where3(active, new_tp, path.throughput))
    return PathState(throughput=tp, radiance=radiance, active=still)


def finalize(params, path_radiance, accum):
    """finalizePathTracingKernel: per-pixel sum over spp -> accum add ->
    normalize -> sRGB u8. Returns (image_u8 [rows, W, 3], new_accum)."""
    spp = params.samples_per_pixel
    p = path_radiance.shape[1] // spp
    new_accum = accum + path_radiance.reshape(3, spp, p).sum(dim=1)
    dev = path_radiance.device
    with spans.span("sync.sampleCount"):
        offset = torch.tensor(float(params.sample_offset & 0xFFFFFFFF),
                              dtype=torch.float32, device=dev)
        count = torch.tensor(float(spp), dtype=torch.float32, device=dev)
    inv = 1.0 / (offset + count)
    img = encode_srgb_u8(new_accum * inv).reshape(3, p // params.width,
                                                  params.width)
    return img.permute(1, 2, 0).contiguous(), new_accum


def accum_image(params, accum, total_spp: int):
    """Image straight from an accumulation buffer: normalize by the total
    sample count and sRGB-encode. Returns u8 [rows, W, 3]."""
    with spans.span("sync.sampleCount"):
        count = torch.tensor(float(total_spp), dtype=torch.float32,
                             device=accum.device)
    color = accum * (1.0 / count)
    img = encode_srgb_u8(color).reshape(3, -1, params.width)
    return img.permute(1, 2, 0).contiguous()


def lambert_shade(params, env, hits: HitState, prim_dirs):
    """N.V shading, raw environment on a miss, average over spp. Returns
    the image u8 [rows, W, 3]."""
    normal = safe_normalize(hits.normal, min_len=0.0)
    normal = where3(dot(normal, prim_dirs) > 0.0, -normal, normal)
    ndotl = torch.clamp(dot(normal, -prim_dirs), min=0.0)
    lit = hits.albedo * ndotl[None, :]
    color = where3(hits.hit, lit, sample_environment(env, prim_dirs))
    spp = params.samples_per_pixel
    p = color.shape[1] // spp
    avg = color.reshape(3, spp, p).mean(dim=1)
    img = encode_srgb_u8(avg).reshape(3, p // params.width, params.width)
    return img.permute(1, 2, 0).contiguous()


def guide_buffers(params, hits: HitState, n_rows: int | None = None):
    """Sample-0 primary-hit normals and albedo as [3, rows, W] (rows =
    n_rows, else the frame's height): the denoiser's guides."""
    rows = params.height if n_rows is None else int(n_rows)
    p = rows * params.width
    return (hits.normal[:, :p].reshape(3, rows, params.width),
            hits.albedo[:, :p].reshape(3, rows, params.width))


def render_gt_frame(mesh, env, params, accum, return_guides: bool = False,
                    row0: int = 0, n_rows: int | None = None):
    """One accumulation batch of ground-truth path tracing. Returns
    (image_u8 [H, W, 3], new_accum [3, H*W])[, (guide_normals,
    guide_albedo)]. sample_offset must advance by samples_per_pixel between
    calls. row0 / n_rows render the stripe of rows [row0, row0 + n_rows)
    with global pixel ids; accum [3, n_rows*W] and the outputs cover that
    stripe."""
    with spans.span("primaryRays"):
        pixel_idx, sample_of, _, origins, dirs = primary_rays(params, row0,
                                                              n_rows)
    with spans.span("primaryTrace"):
        hits = trace_primary_gt(mesh, params, origins, dirs)
    with spans.span("initPathState"):
        path = init_path_state(params, env, hits, dirs)

    incoming = None
    cur_hits = hits
    for bounce in range(1, params.max_bounces + 1):
        # Once no path is active a bounce is an exact identity on the path
        # state (the trace masks on pdf > 0; integration writes under
        # active masks).
        if incoming is not None and not any_active(path):
            break
        with spans.span("sampleBounce"):
            rays, active = sample_bounce(params, pixel_idx, sample_of,
                                         cur_hits, path.active, incoming)
            path = path._replace(active=active)
        with spans.span("bounceTrace"):
            bounce_hits = trace_bounces_gt(mesh, params, rays)
        with spans.span("integrateBounce"):
            path = integrate_bounce(params, env, path, bounce_hits, rays,
                                    bounce, pixel_idx, sample_of)
        incoming, cur_hits = rays.direction, bounce_hits
    with spans.span("finalize"):
        img, new_accum = finalize(params, path.radiance, accum)
    if return_guides:
        return img, new_accum, guide_buffers(params, hits, n_rows)
    return img, new_accum


def render_gt_lambert(mesh, env, params):
    _, _, _, origins, dirs = primary_rays(params)
    hits = trace_primary_gt(mesh, params, origins, dirs)
    return lambert_shade(params, env, hits, dirs)
