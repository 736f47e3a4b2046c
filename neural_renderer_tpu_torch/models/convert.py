"""Carry weights and meshes from the JAX package's numpy arrays, and write
weights back in the same `.npz` layout.

The functions take numpy arrays only, so a caller converts a JAX pytree
with `np.asarray` (or loads an `.npz` written from one) and this package
never imports JAX. The `.npz` layout is that of
scripts/export_lane_ckpt_npz.py: `lane` and `mlp_<i>`, f32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.mesh import MeshTensors
from .nbvh import NbvhConfig, ShellNetwork


def params_from_numpy(np_params, config: NbvhConfig,
                      device="cuda") -> ShellNetwork:
    """The lane-grid params pytree of `neural_renderer_tpu.models.nbvh.
    init_params` / a restored checkpoint, as numpy:
    {"lane": [P, L, F, S, (2,) 128] f32, "mlp": [[out, in] f32, ...]}
    -> ShellNetwork on `device`."""
    lane = np.array(np_params["lane"], np.float32)
    expect = (config.point_count, config.n_levels, config.n_features,
              config.lane_sublanes)
    if lane.shape[:4] != expect or lane.shape[-1] != 128 or \
            (lane.ndim == 6) != (config.lane_entry_pack == 2):
        raise ValueError(f"lane tables {lane.shape} do not fit {config}")
    mlp = [torch.as_tensor(np.array(w, np.float32), device=device)
           for w in np_params["mlp"]]
    return ShellNetwork(config, torch.as_tensor(lane, device=device), mlp)


def load_params_npz(path: str) -> dict:
    """Read an .npz written by scripts/export_lane_ckpt_npz.py into the
    numpy params layout params_from_numpy takes."""
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("mlp_"))
        return {"lane": z["lane"], "mlp": [z[f"mlp_{i}"] for i in range(n)]}


def params_to_numpy(net: ShellNetwork) -> dict:
    """The inverse of params_from_numpy: {"lane": [P, L, F, S, (2,) 128],
    "mlp": [[out, in], ...]} as f32 numpy arrays on the host."""
    return {"lane": net.lane.detach().cpu().numpy(),
            "mlp": [w.detach().cpu().numpy() for w in net.mlp]}


def save_params_npz(path: str, net: ShellNetwork) -> str:
    """Write `net` as the `.npz` that load_params_npz reads (the layout of
    scripts/export_lane_ckpt_npz.py). Returns the path."""
    params = params_to_numpy(net)
    arrays = {"lane": params["lane"]}
    arrays.update({f"mlp_{i}": w for i, w in enumerate(params["mlp"])})
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
    tri_material [T], nodes_packed [11, N], mat_scalars [NUM_SCALARS, M] and
    the flags has_normals, has_uvs, has_materials, max_leaf."""
    return MeshTensors.from_packed(np.asarray(tris_packed, np.float32),
                                   int(num_triangles), device=device,
                                   **fields)
