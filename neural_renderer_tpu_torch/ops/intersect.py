"""Slab test, hit-data computation and material resolution.

Port of `neural_renderer_tpu/ops/intersect.py`: `intersect_aabb`,
`compute_hit_data` (barycentric position, smooth shading normal, uv and
material id) and `resolve_material` for the global row and per-mesh constant
rows. Texture sampling and normal maps are not ported yet: a mesh that
carries textures raises NotImplementedError. All vectors are channel-major
[3, N].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.materials import (
    P_ANISOTROPY, P_BASE_B, P_BASE_G, P_BASE_R, P_CLEARCOAT,
    P_CLEARCOAT_GLOSS, P_EMISSION_B, P_EMISSION_G, P_EMISSION_R,
    P_EMISSION_SCALE, P_IOR, P_METALLIC, P_ROUGHNESS, P_SHEEN, P_SHEEN_TINT,
    P_SPEC_TRANS, P_SPECULAR, P_SPECULAR_TINT)
from .linalg import cross, safe_normalize


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


class HitData(NamedTuple):
    position: torch.Tensor          # [3, N]
    t: torch.Tensor                 # [N]
    shading_normal: torch.Tensor    # [3, N]
    geometric_normal: torch.Tensor  # [3, N]
    uv: torch.Tensor                # [2, N]
    material_id: torch.Tensor       # [N] int64 (-1 = global)


def compute_hit_data(mesh, origins, dirs, tri_idx, u, v, t) -> HitData:
    """Barycentric position / normal / uv and the material id of each hit.
    The caller masks out misses."""
    if mesh.has_normal_maps:
        raise NotImplementedError(
            "normal maps need the texture atlas sampler, not ported yet")
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
    `global_scalars` [NUM_SCALARS], otherwise the mesh's constant row."""
    if mesh.has_textures:
        raise NotImplementedError(
            "textured materials need the texture atlas sampler, not ported "
            "yet")
    n = material_id.shape[0]
    if mesh.has_materials:
        use_mesh = material_id >= 0
        mid = torch.clamp(material_id, 0, mesh.mat_scalars.shape[1] - 1)

        def scalar(k):
            return torch.where(use_mesh, mesh.mat_scalars[k][mid],
                               global_scalars[k])
    else:
        def scalar(k):
            return global_scalars[k].expand(n)

    return ResolvedMaterial(
        base_color=torch.stack([scalar(P_BASE_R), scalar(P_BASE_G),
                                scalar(P_BASE_B)], dim=0),
        metallic=scalar(P_METALLIC),
        roughness=scalar(P_ROUGHNESS),
        specular=scalar(P_SPECULAR),
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
