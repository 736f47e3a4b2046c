"""Slab test, texture sampling, hit-data computation and material
resolution.

Port of `neural_renderer_tpu/ops/intersect.py`: `intersect_aabb`,
`ortho_basis`, `sample_texture` (the packed atlas: uv wrapped by fract, then
nearest by truncation or bilinear over [0, dim - 1], with the clamps),
`compute_hit_data` (barycentric position, smooth shading normal, uv,
material id and the normal map) and `resolve_material` (the global row, the
per-mesh rows and their textured base colour, metallic, roughness and
specular). All vectors are channel-major [3, N].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.materials import (
    P_ANISOTROPY, P_BASE_B, P_BASE_G, P_BASE_R, P_CLEARCOAT,
    P_CLEARCOAT_GLOSS, P_EMISSION_B, P_EMISSION_G, P_EMISSION_R,
    P_EMISSION_SCALE, P_IOR, P_METALLIC, P_ROUGHNESS, P_SHEEN, P_SHEEN_TINT,
    P_SPEC_TRANS, P_SPECULAR, P_SPECULAR_TINT, T_BASE_COLOR, T_METALLIC,
    T_NORMAL, T_ROUGHNESS, T_SPECULAR)
from .linalg import cross, safe_normalize, where3


def intersect_aabb(origins, inv_dirs, bounds_min, bounds_max, t_max):
    """Slab test with a 1e-10 bound expansion. [3, N] operands; returns
    (hit, t_near)."""
    eps = 1e-10
    t1 = (bounds_min - eps - origins) * inv_dirs
    t2 = (bounds_max + eps - origins) * inv_dirs
    tmin = torch.minimum(t1, t2).amax(dim=0)
    tmax = torch.maximum(t1, t2).amin(dim=0)
    hit = ~((tmax < 0.0) | (tmin > t_max) | (tmin > tmax))
    return hit, tmin


def ortho_basis(normal):
    """Tangent and bitangent of a [3, N] normal."""
    ax = torch.abs(normal[0]) < 0.6
    ay = torch.abs(normal[1]) < 0.6
    b = torch.stack([ax, (~ax) & ay, (~ax) & (~ay)], dim=0).to(normal.dtype)
    tangent = safe_normalize(cross(b, normal), eps=1e-20)
    bitangent = safe_normalize(cross(normal, tangent), eps=1e-20)
    return tangent, bitangent


def sample_texture(mesh, tex_id, u, v):
    """Sample the packed atlas [3, P] at uv; returns (rgb [3, N], valid
    [N]), valid where tex_id >= 0."""
    valid = tex_id >= 0
    tid = torch.clamp(tex_id, 0, mesh.tex_width.shape[0] - 1)
    w = mesh.tex_width[tid]
    h = mesh.tex_height[tid]
    off = mesh.tex_offset[tid]
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    last = mesh.atlas.shape[1] - 1

    def fetch(xi, yi):
        return mesh.atlas[:, torch.clamp(off + yi * w + xi, 0, last)]

    f32 = torch.float32
    if mesh.texture_nearest:
        x = torch.minimum(torch.clamp((uu * w.to(f32)).to(torch.int64),
                                      min=0), w - 1)
        y = torch.minimum(torch.clamp((vv * h.to(f32)).to(torch.int64),
                                      min=0), h - 1)
        return fetch(x, y), valid

    x = uu * (w - 1).to(f32)
    y = vv * (h - 1).to(f32)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.minimum(x0 + 1, w - 1)
    y1 = torch.minimum(y0 + 1, h - 1)
    tx = (x - x0.to(f32))[None, :]
    ty = (y - y0.to(f32))[None, :]
    c0 = fetch(x0, y0) * (1.0 - tx) + fetch(x1, y0) * tx
    c1 = fetch(x0, y1) * (1.0 - tx) + fetch(x1, y1) * tx
    return c0 * (1.0 - ty) + c1 * ty, valid


class HitData(NamedTuple):
    position: torch.Tensor          # [3, N]
    t: torch.Tensor                 # [N]
    shading_normal: torch.Tensor    # [3, N]
    geometric_normal: torch.Tensor  # [3, N]
    uv: torch.Tensor                # [2, N]
    material_id: torch.Tensor       # [N] int64 (-1 = global)


def compute_hit_data(mesh, origins, dirs, tri_idx, u, v, t) -> HitData:
    """Barycentric position / normal / uv, the material id and the normal
    map of each hit. The caller masks out misses."""
    tri = torch.clamp(tri_idx, 0, mesh.indices.shape[1] - 1)
    idx = mesh.indices[:, tri]
    v0 = mesh.vertices[:, idx[0]]
    v1 = mesh.vertices[:, idx[1]]
    v2 = mesh.vertices[:, idx[2]]
    w = (1.0 - u - v)[None, :]
    uu = u[None, :]
    vv = v[None, :]

    geom_n = safe_normalize(cross(v1 - v0, v2 - v0), eps=1e-20)
    if mesh.has_normals:
        shading_n = safe_normalize(
            mesh.normals[:, idx[0]] * w + mesh.normals[:, idx[1]] * uu
            + mesh.normals[:, idx[2]] * vv, eps=1e-20)
    else:
        shading_n = geom_n

    position = v0 * w + v1 * uu + v2 * vv

    if mesh.has_uvs:
        uv_out = (mesh.uvs[:, idx[0]] * w + mesh.uvs[:, idx[1]] * uu
                  + mesh.uvs[:, idx[2]] * vv)
    else:
        uv_out = torch.stack([u, v], dim=0)

    if mesh.has_materials:
        material_id = mesh.tri_material[tri]
    else:
        material_id = torch.full_like(tri, -1)

    if mesh.has_normal_maps:
        mid = torch.clamp(material_id, 0, mesh.mat_tex_ids.shape[1] - 1)
        ntex = torch.where(material_id >= 0, mesh.mat_tex_ids[T_NORMAL][mid],
                           -1)
        tex_n, valid = sample_texture(mesh, ntex, uv_out[0], uv_out[1])
        valid = valid & (tex_n[0] >= 0.0)
        ts_n = safe_normalize(tex_n * 2.0 - 1.0, eps=1e-20)
        tang, bitang = ortho_basis(shading_n)
        mapped = safe_normalize(
            tang * ts_n[0][None, :] + bitang * ts_n[1][None, :]
            + shading_n * ts_n[2][None, :], eps=1e-20)
        shading_n = where3(valid, mapped, shading_n)
    return HitData(position=position, t=t, shading_normal=shading_n,
                   geometric_normal=geom_n, uv=uv_out,
                   material_id=material_id)


class ResolvedMaterial(NamedTuple):
    base_color: torch.Tensor   # [3, N]
    metallic: torch.Tensor     # [N]
    roughness: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    anisotropy: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    emission: torch.Tensor     # [3, N]
    emission_scale: torch.Tensor
    ior: torch.Tensor
    specular_transmission: torch.Tensor


def resolve_material(mesh, material_id, uv, global_scalars) -> ResolvedMaterial:
    """Per-hit material: material_id < 0 (or a mesh without materials) takes
    `global_scalars` [NUM_SCALARS], otherwise the mesh's row, whose base
    colour, metallic, roughness and specular may sample the atlas."""
    n = material_id.shape[0]
    use_mesh = (material_id >= 0) & bool(mesh.has_materials)
    mid = torch.clamp(material_id, 0, mesh.mat_scalars.shape[1] - 1)
    if mesh.has_materials:
        def scalar(k):
            return torch.where(use_mesh, mesh.mat_scalars[k][mid],
                               global_scalars[k])
    else:
        def scalar(k):
            return global_scalars[k].expand(n)

    base_color = torch.stack([scalar(P_BASE_R), scalar(P_BASE_G),
                              scalar(P_BASE_B)], dim=0)
    metallic = scalar(P_METALLIC)
    roughness = scalar(P_ROUGHNESS)
    specular = scalar(P_SPECULAR)
    if mesh.has_textures:
        def tex_slot(slot):
            return torch.where(use_mesh, mesh.mat_tex_ids[slot][mid], -1)

        def tex_scalar(slot, const):
            rgb, valid = sample_texture(mesh, tex_slot(slot), uv[0], uv[1])
            ch = torch.clamp(mesh.mat_tex_chans[slot][mid], 0, 2)
            val = torch.gather(rgb, 0, ch[None, :])[0]
            return torch.where(valid, val, const)

        rgb_bc, valid_bc = sample_texture(mesh, tex_slot(T_BASE_COLOR),
                                          uv[0], uv[1])
        base_color = where3(valid_bc, rgb_bc, base_color)
        metallic = tex_scalar(T_METALLIC, metallic)
        roughness = tex_scalar(T_ROUGHNESS, roughness)
        specular = tex_scalar(T_SPECULAR, specular)

    return ResolvedMaterial(
        base_color=base_color,
        metallic=metallic,
        roughness=roughness,
        specular=specular,
        specular_tint=scalar(P_SPECULAR_TINT),
        anisotropy=scalar(P_ANISOTROPY),
        sheen=scalar(P_SHEEN),
        sheen_tint=scalar(P_SHEEN_TINT),
        clearcoat=scalar(P_CLEARCOAT),
        clearcoat_gloss=scalar(P_CLEARCOAT_GLOSS),
        emission=torch.stack([scalar(P_EMISSION_R), scalar(P_EMISSION_G),
                              scalar(P_EMISSION_B)], dim=0),
        emission_scale=scalar(P_EMISSION_SCALE),
        ior=scalar(P_IOR),
        specular_transmission=scalar(P_SPEC_TRANS),
    )
