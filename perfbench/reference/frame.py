"""The plain reference frame: ground-truth and neural path tracing of
chosen samples, in float32 with TF32 off.

A sample is a (pixel, stream) pair: the stream is the sample offset plus
the sample's index within its batch, which is all the RNG sees, so any
set of samples of any frames renders in one batch. Each sample follows
the renderer's wavefront path tracer (Alehandreus/neural-renderer):
jittered camera ray; its hit (the closest front face of the original
mesh, or the shell march); then up to `bounces` Disney 3-lobe bounces,
environment light on a miss and Russian roulette after each bounce but
the last. The neural query marches segments between the outer and inner
shells (at most 10): a segment runs from its entry to the first
backward crossing of the outer shell or the first inner crossing; the
network's presence logit >= 0, or an inner crossing, ends the march with
the network's distance, normal and colour; otherwise the march re-enters
at the next forward crossing of the outer shell. Bounce rays enter at
their first forward outer crossing, and a path dies where a bounce ray
meets the inner shell before the outer.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import brdf
from .geometry import (ANY, FORWARD_ONLY, MISS, Mesh, closest_hit,
                       nearest_by_facing)
from .network import Network
from .vec import (NUM_SCALARS, P_BASE_B, P_BASE_R, P_CLEARCOAT,
                  P_CLEARCOAT_GLOSS, P_EMISSION_SCALE, P_IOR, P_METALLIC,
                  P_ROUGHNESS, P_SPECULAR, P_SPECULAR_TINT, P_ANISOTROPY,
                  P_SHEEN, P_SHEEN_TINT, camera_rays, dot, init_rng, rand01,
                  safe_normalize, sky, where3)

MAX_SEGMENTS = 10
SEGMENT_EPSILON = 1e-8
MAX_RADIANCE = 100.0
# Samples traced at once.
SAMPLES_PER_CHUNK = 1 << 17

# The material block's defaults where a scene file leaves a key out.
_MATERIAL_DEFAULTS = dict(base_color=(1.0, 1.0, 1.0), roughness=1.0,
                          metallic=0.0, specular=0.0, specular_tint=0.0,
                          anisotropy=0.0, sheen=0.0, sheen_tint=0.0,
                          clearcoat=0.0, clearcoat_gloss=0.0)


def material_row(block: dict) -> np.ndarray:
    """The global material's scalar row from a scene file's material
    block (no emission, ior 1.5, no transmission)."""
    m = dict(_MATERIAL_DEFAULTS, **block)
    row = np.zeros(NUM_SCALARS, np.float32)
    row[P_BASE_R:P_BASE_B + 1] = m["base_color"]
    row[P_METALLIC] = m["metallic"]
    row[P_ROUGHNESS] = m["roughness"]
    row[P_SPECULAR] = m["specular"]
    row[P_SPECULAR_TINT] = m["specular_tint"]
    row[P_ANISOTROPY] = m["anisotropy"]
    row[P_SHEEN] = m["sheen"]
    row[P_SHEEN_TINT] = m["sheen_tint"]
    row[P_CLEARCOAT] = m["clearcoat"]
    row[P_CLEARCOAT_GLOSS] = m["clearcoat_gloss"]
    row[P_EMISSION_SCALE] = 1.0
    row[P_IOR] = 1.5
    return row


@dataclass
class Scene:
    original: Mesh
    inner: Mesh
    outer: Mesh
    row: torch.Tensor          # [NUM_SCALARS]
    scene_scale: torch.Tensor  # f32 scalar: the original mesh's diagonal
    outer_min: torch.Tensor    # [3]
    outer_inv: torch.Tensor    # [3]: 1 / the outer shell's extent
    net: Network | None = None

    @staticmethod
    def from_file(path: str, device, neural: bool,
                  precision: str = "f32") -> "Scene":
        """The scene a benchmark configuration file describes (paths
        relative to the file), without an environment map."""
        with open(path) as f:
            cfg = json.load(f)
        if cfg.get("environment", {}).get("hdri_path"):
            raise ValueError("the reference frame has the procedural sky "
                             "only")
        base = os.path.dirname(os.path.abspath(path))

        def mesh(key):
            return Mesh.from_obj(os.path.join(base,
                                              cfg["scene"][key]["path"]),
                                 device)
        original, inner, outer = (mesh(k) for k in ("original_mesh",
                                                    "inner_shell",
                                                    "outer_shell"))
        scale = float(np.linalg.norm(original.bmax - original.bmin))
        ext = outer.bmax - outer.bmin
        net = None
        if neural:
            nn_cfg = cfg["neural_network"]
            net = Network.from_npz(os.path.join(base,
                                                cfg["checkpoint_path"]),
                                   nn_cfg["base_resolution"], device,
                                   precision)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        return Scene(original, inner, outer,
                     t(material_row(cfg.get("material", {}))),
                     t(scale if scale >= 1e-6 else 1.0), t(outer.bmin),
                     t(np.where(ext != 0.0,
                                1.0 / np.where(ext == 0, 1, ext), 0.0)),
                     net)


class Hits(NamedTuple):
    position: torch.Tensor   # [3, N]
    normal: torch.Tensor     # [3, N]
    albedo: torch.Tensor     # [3, N]
    params: torch.Tensor     # [3, N]: metallic, roughness, specular
    hit: torch.Tensor        # [N] bool
    distance: torch.Tensor   # [N]


def _global_params(row, n):
    return torch.stack([row[P_METALLIC].expand(n),
                        row[P_ROUGHNESS].expand(n),
                        row[P_SPECULAR].expand(n)], dim=0)


def _mesh_hits(scene: Scene, o, d, mode, active=None, low=False) -> Hits:
    """Closest hits on the original mesh with their shading data."""
    m = scene.original
    t, tri, u, v = closest_hit(m, o, d, mode, active, low)
    hit = t < MISS
    w = (1.0 - u - v)[None, :]
    uu, vv = u[None, :], v[None, :]
    pos = m.v0[:, tri] * w + m.v1[:, tri] * uu + m.v2[:, tri] * vv
    nrm = safe_normalize(m.n0[:, tri] * w + m.n1[:, tri] * uu
                         + m.n2[:, tri] * vv)
    n = o.shape[1]
    zero3 = torch.zeros((3, n), dtype=torch.float32, device=o.device)
    base = scene.row[P_BASE_R:P_BASE_B + 1][:, None].expand(3, n)
    return Hits(where3(hit, pos, zero3), where3(hit, nrm, zero3),
                where3(hit, base, zero3), _global_params(scene.row, n), hit,
                torch.where(hit, t, torch.zeros_like(t)))


def march(scene: Scene, dirs, entry_pos, active, low=False) -> Hits:
    """The multi-segment shell march of rays along `dirs` from their shell
    entries (where `active`)."""
    n = dirs.shape[1]
    dev = dirs.device
    pos = torch.zeros((3, n), dtype=torch.float32, device=dev)
    nrm, col = pos.clone(), pos.clone()
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    dist = torch.zeros(n, dtype=torch.float32, device=dev)
    entry = entry_pos.clone()
    active = active.clone()
    eps = SEGMENT_EPSILON
    for _ in range(MAX_SEGMENTS):
        idx = torch.nonzero(active).squeeze(1)
        if idx.numel() == 0:
            break
        d = dirs[:, idx]
        start = entry[:, idx] + d * eps
        _, outer_bwd = nearest_by_facing(scene.outer, start, d, low=low)
        inner_f, inner_b = nearest_by_facing(scene.inner, start, d, low=low)
        inner_any = torch.minimum(inner_f, inner_b)
        exit_t = torch.where(outer_bwd < 1e30, outer_bwd,
                             torch.full_like(outer_bwd, eps))
        inner_hit = inner_any < 1e30
        inner_t = torch.where(inner_hit, inner_any,
                              torch.full_like(inner_any, MISS))
        inner_before = inner_hit & (inner_t < exit_t)
        seg_t = torch.where(inner_before, inner_t, exit_t)
        exit_pos = start + d * seg_t[None, :]
        lo, inv = scene.outer_min[:, None], scene.outer_inv[:, None]
        net_in = torch.cat([(start - lo) * inv, (exit_pos - lo) * inv,
                            (0.5 * (start + exit_pos) - lo) * inv,
                            (d + 1.0) * 0.5], dim=0)
        out = scene.net(net_in)
        found = (out[0] >= 0.0) | inner_before
        distance = out[1]
        clamped = torch.where(inner_t > 0.0,
                              torch.minimum(distance, inner_t - eps),
                              distance)
        fidx = idx[found]
        pos[:, fidx] = (start + d * clamped[None, :])[:, found]
        nrm[:, fidx] = safe_normalize(out[2:5], min_len=1e-6)[:, found]
        col[:, fidx] = torch.clamp(out[5:8], 0.0, 1.0)[:, found]
        hit[fidx] = True
        dist[fidx] = distance[found]

        still = ~found
        past_exit = exit_pos + d * eps
        t_re, _, _, _ = closest_hit(scene.outer, past_exit, d, FORWARD_ONLY,
                                    active=still, low=low)
        re_hit = still & (t_re < MISS)
        go = still & (re_hit | inner_hit)
        re_t = torch.where(re_hit, t_re, torch.zeros_like(t_re))
        cidx = idx[go]
        entry[:, cidx] = (past_exit + d * re_t[None, :])[:, go]
        active[idx] = go
    zero3 = torch.zeros_like(pos)
    params = where3(hit, _global_params(scene.row, n), zero3)
    return Hits(pos, nrm, col, params, hit, dist)


def _camera_neural(scene: Scene, o, d, low=False) -> Hits:
    t, _, _, _ = closest_hit(scene.outer, o, d, FORWARD_ONLY, low=low)
    active = t < MISS
    entry = where3(active, o + d * t[None, :], torch.zeros_like(o))
    return march(scene, d, entry, active, low)


class Rays(NamedTuple):
    origin: torch.Tensor
    direction: torch.Tensor
    pdf: torch.Tensor
    weight: torch.Tensor    # [3, N]: f * cos / pdf
    distance: torch.Tensor


def _bounce_neural(scene: Scene, rays: Rays, path_active, low=False):
    """(hits, active) of bounce rays: early termination at the inner shell,
    the entry at the first forward outer crossing, then the march."""
    mask = path_active & (rays.pdf > 0.0)
    o, d = rays.origin, rays.direction
    of, ob = nearest_by_facing(scene.outer, o, d, active=mask, low=low)
    inf_, inb = nearest_by_facing(scene.inner, o, d, active=mask, low=low)
    outer_any, inner_any = torch.minimum(of, ob), torch.minimum(inf_, inb)
    kill = (mask & (rays.distance > 0.0) & (inner_any < 1e30)
            & (outer_any < 1e30) & (inner_any < outer_any))
    active = mask & ~kill
    enter = active & (of < 1e30)
    entry = where3(enter, o + d * of[None, :], torch.zeros_like(o))
    return march(scene, d, entry, enter, low), active


def _sample_bounce(scene: Scene, view, pix, stream, hits: Hits, path_active,
                   incoming) -> Rays:
    state = init_rng(pix, stream)
    if incoming is None:
        state, _, incoming = camera_rays(pix % view.width, pix // view.width,
                                         state, view.cam, view.width,
                                         view.height)
    normal = safe_normalize(hits.normal, min_len=0.0)
    normal = where3(dot(normal, incoming) > 0.0, -normal, normal)
    wo = -incoming
    tangent, bitangent = brdf.build_tangent_space(normal)
    mat = brdf.BrdfMaterial.broadcast_from_row(scene.row, pix.shape[0])
    mat = mat._replace(base_color=hits.albedo, metallic=hits.params[0],
                       roughness=hits.params[1], specular=hits.params[2])
    state, u1 = rand01(state)
    state, u2 = rand01(state)
    state, u3 = rand01(state)
    wi, pdf = brdf.disney_sample_3component(mat, normal, wo, tangent,
                                            bitangent, u1, u2, u3)
    f = brdf.disney_eval(mat, normal, wo, wi, tangent, bitangent)
    cos_t = torch.abs(dot(normal, wi))
    weight = f * (cos_t / torch.where(pdf > 0.0, pdf,
                                      torch.ones_like(pdf)))[None, :]
    valid = (hits.hit & path_active & (pdf > 0.0)
             & torch.isfinite(weight).all(dim=0))
    origin = hits.position + normal * (scene.scene_scale * 1e-6)
    zero3 = torch.zeros_like(origin)
    return Rays(where3(valid, origin, zero3), where3(valid, wi, zero3),
                torch.where(valid, pdf, torch.zeros_like(pdf)),
                where3(valid, weight, zero3), hits.distance)


@dataclass
class View:
    width: int
    height: int
    bounces: int
    cam: dict   # pos, forward, right, up [3] and fov_y, float32 tensors


def _render_chunk(scene: Scene, view: View, pix, stream, neural: bool,
                  low: bool):
    state = init_rng(pix, stream)
    _, o, d = camera_rays(pix % view.width, pix // view.width, state,
                          view.cam, view.width, view.height)
    hits = (_camera_neural(scene, o, d, low) if neural
            else _mesh_hits(scene, o, d, FORWARD_ONLY, low=low))
    n = pix.shape[0]
    radiance = where3(hits.hit, torch.zeros((3, n), device=o.device),
                      sky(d, MAX_RADIANCE))
    throughput = torch.ones((3, n), dtype=torch.float32, device=o.device)
    active = hits.hit
    incoming, cur = None, hits
    for bounce in range(1, view.bounces + 1):
        if incoming is not None and not bool(active.any()):
            break
        rays = _sample_bounce(scene, view, pix, stream, cur, active,
                              incoming)
        active = active & cur.hit & (rays.pdf > 0.0)
        if neural:
            nxt, active = _bounce_neural(scene, rays, active, low)
        else:
            nxt = _mesh_hits(scene, rays.origin, rays.direction, ANY,
                             active=rays.pdf > 0.0, low=low)
        new_tp = throughput * rays.weight
        env = sky(rays.direction, MAX_RADIANCE)
        missed = active & ~nxt.hit
        radiance = where3(missed, radiance + new_tp * env, radiance)
        if bounce >= view.bounces:
            break
        survival = torch.clamp(new_tp.amax(dim=0), max=1.0)
        _, rr = rand01(init_rng(pix, stream + bounce))
        still = active & nxt.hit & (rr < survival)
        throughput = where3(still, new_tp / torch.clamp(
            survival, min=1e-20)[None, :], where3(active, new_tp,
                                                  throughput))
        active = still
        incoming, cur = rays.direction, nxt
    return radiance


def render_samples(scene: Scene, view: View, pix, stream,
                   low_geometry: bool = False):
    """Radiance [3, N] of samples (pix [N], stream [N]) int64; neural
    where the scene has a network. low_geometry computes every ray-
    triangle test in bfloat16 (the control)."""
    neural = scene.net is not None
    out = torch.empty((3, pix.shape[0]), dtype=torch.float32,
                      device=pix.device)
    for s in range(0, pix.shape[0], SAMPLES_PER_CHUNK):
        sl = slice(s, s + SAMPLES_PER_CHUNK)
        out[:, sl] = _render_chunk(scene, view, pix[sl], stream[sl], neural,
                                   low_geometry)
    return out
