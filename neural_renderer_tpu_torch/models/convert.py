"""Carry weights and meshes from the JAX package's numpy arrays, and write
weights back in the same `.npz` layout.

The functions take numpy arrays only, so a caller converts a JAX pytree
with `np.asarray` (or loads an `.npz` written from one) and this package
never imports JAX. The `.npz` layout is that of
scripts/export_lane_ckpt_npz.py, `lane` and `mlp_<i>`, f32; tcnn networks
store the level tables of their one shared hash grid as `grid_<l>`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.mesh import MeshTensors
from .nbvh import NbvhConfig, ShellNetwork


def params_from_numpy(np_params, config: NbvhConfig,
                      device="cuda") -> ShellNetwork:
    """The params pytree of `neural_renderer_tpu.models.nbvh.init_params` /
    a restored checkpoint / `load_flat_blob`, as numpy -> ShellNetwork on
    `device`. Lane: {"lane": [P, L, F, S, (2,) 128], "mlp": [[out, in],
    ...]}; tcnn: {"grids": [[[E_l, F] x L]], "mlp": [...]}, one grid that
    every encoder slot shares."""
    mlp = [torch.as_tensor(np.array(w, np.float32), device=device)
           for w in np_params["mlp"]]
    if config.grid_type == "tcnn":
        grids = np_params["grids"]
        if len(grids) != 1:
            raise ValueError(f"{len(grids)} hash grids: a tcnn network holds "
                             "one, shared by its encoder slots")
        grid_cfg = config.grid
        shapes = [tuple(np.shape(t)) for t in grids[0]]
        expect = [(grid_cfg.level_entries(lv), grid_cfg.n_features)
                  for lv in range(grid_cfg.n_levels)]
        if shapes != expect:
            raise ValueError(f"hash grid tables {shapes} do not fit {config}")
        return ShellNetwork(config, mlp, grid=[
            torch.as_tensor(np.array(t, np.float32), device=device)
            for t in grids[0]])
    lane = np.array(np_params["lane"], np.float32)
    expect = (config.point_count, config.n_levels, config.n_features,
              config.lane_sublanes)
    if lane.shape[:4] != expect or lane.shape[-1] != 128 or \
            (lane.ndim == 6) != (config.lane_entry_pack == 2):
        raise ValueError(f"lane tables {lane.shape} do not fit {config}")
    return ShellNetwork(config, mlp,
                        lane=torch.as_tensor(lane, device=device))


def param_names(net: ShellNetwork) -> list[str]:
    """The `.npz` key of each of `net.parameters()`, in that order: `lane`
    or the hash grid's level tables `grid_<l>`, then `mlp_<i>`."""
    names = (["lane"] if net.grid is None
             else [f"grid_{lv}" for lv in range(len(net.grid))])
    return names + [f"mlp_{i}" for i in range(len(net.mlp))]


def load_params_npz(path: str) -> dict:
    """Read an .npz written by save_params_npz or
    scripts/export_lane_ckpt_npz.py into the numpy params layout
    params_from_numpy takes."""
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("mlp_"))
        params = {"mlp": [z[f"mlp_{i}"] for i in range(n)]}
        if "lane" in z.files:
            params["lane"] = z["lane"]
            return params
        n_levels = sum(1 for k in z.files if k.startswith("grid_"))
        params["grids"] = [[z[f"grid_{lv}"] for lv in range(n_levels)]]
        return params


def params_to_numpy(net: ShellNetwork) -> dict:
    """The inverse of params_from_numpy: {"lane": ..., "mlp": [...]} or
    {"grids": [[E_l, F] x L], "mlp": [...]} as f32 numpy arrays on the
    host."""
    mlp = [w.detach().cpu().numpy() for w in net.mlp]
    if net.grid is not None:
        return {"grids": [[t.detach().cpu().numpy() for t in net.grid]],
                "mlp": mlp}
    return {"lane": net.lane.detach().cpu().numpy(), "mlp": mlp}


def save_params_npz(path: str, net: ShellNetwork) -> str:
    """Write `net` as the `.npz` that load_params_npz reads, one array per
    parameter under param_names. Returns the path."""
    arrays = {name: p.detach().cpu().numpy()
              for name, p in zip(param_names(net), net.parameters())}
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def mesh_from_numpy(tris_packed: np.ndarray, num_triangles: int,
                    device="cuda", **fields) -> MeshTensors:
    """MeshTensors from a JAX `MeshArrays` carried across as numpy, keeping
    its (leaf) triangle order, so both packages number triangles alike.
    `tris_packed` [9, T] and `num_triangles` suffice for the shell traces;
    `fields` may add what the ground-truth path reads, under MeshArrays'
    names and layouts: vertices [3, V], normals, uvs [2, V], indices [3, T],
    tri_material [T], nodes_packed [11, N], mat_scalars [NUM_SCALARS, M],
    mat_tex_ids and mat_tex_chans [NUM_TEX_SLOTS, M], atlas [3, P],
    tex_offset, tex_width, tex_height [Ntex] and the flags has_normals,
    has_uvs, has_materials, has_textures, has_normal_maps, texture_nearest,
    max_leaf."""
    return MeshTensors.from_packed(np.asarray(tris_packed, np.float32),
                                   int(num_triangles), device=device,
                                   **fields)
