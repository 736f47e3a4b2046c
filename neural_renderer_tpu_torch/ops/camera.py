"""Primary ray generation with pixel jitter.

Port of `neural_renderer_tpu/ops/camera.py` (`generate_primary_rays`). Two
rand01 draws per ray in the reference order, so sample positions match.
"""

from __future__ import annotations

import torch

from ..utils import spans
from .rng import rand01


def generate_primary_rays(px, py, rng_state, cam_pos, cam_forward, cam_right,
                          cam_up, fov_y, width: int, height: int):
    """px, py: [N] int pixel coords; camera vectors [3] float32 tensors.
    Returns (rng_state, origins [3, N], dirs [3, N])."""
    dev = px.device
    f32 = torch.float32
    rng_state, jitter_x = rand01(rng_state)
    rng_state, jitter_y = rand01(rng_state)
    with spans.span("sync.camera"):
        aspect = torch.tensor(width / height, dtype=f32, device=dev)
        w_t = torch.tensor(width, dtype=f32, device=dev)
        h_t = torch.tensor(height, dtype=f32, device=dev)
    u = (px.to(f32) + jitter_x) / w_t
    v = 1.0 - (py.to(f32) + jitter_y) / h_t
    u = u * 2.0 - 1.0
    v = v * 2.0 - 1.0

    tan_half = torch.tan(fov_y * 0.5)
    d = (cam_forward[:, None]
         + cam_right[:, None] * (u * aspect * tan_half)[None, :]
         + cam_up[:, None] * (v * tan_half)[None, :])
    d = d / torch.sqrt((d * d).sum(dim=0, keepdim=True))
    origins = cam_pos[:, None].expand_as(d).contiguous()
    return rng_state, origins, d
