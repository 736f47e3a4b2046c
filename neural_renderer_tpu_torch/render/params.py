"""RenderParams: the per-frame parameter block.

Port of `neural_renderer_tpu/render/params.py`, with the same fields and
defaults. Vector fields are float32 tensors on the frame's device; scalar
fields stay Python numbers (PyTorch runs eagerly, so nothing is traced).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..scene.materials import Material
from ..utils import spans


@dataclass
class RenderParams:
    cam_pos: torch.Tensor        # [3]
    cam_forward: torch.Tensor    # [3]
    cam_right: torch.Tensor      # [3]
    cam_up: torch.Tensor         # [3]
    fov_y: torch.Tensor          # scalar f32
    material_row: torch.Tensor   # [NUM_SCALARS]
    use_constant_neural_color: bool
    constant_neural_color: torch.Tensor   # [3]
    use_direct_env_color: bool
    direct_env_color: torch.Tensor        # [3]
    max_radiance: float
    scene_scale: torch.Tensor   # scalar f32
    sample_offset: int          # accumulated sample count (uint32 semantics)
    outer_shell_min: torch.Tensor         # [3]
    outer_shell_inv_extent: torch.Tensor  # [3]
    width: int = 0
    height: int = 0
    samples_per_pixel: int = 1
    max_bounces: int = 3

    @property
    def device(self):
        return self.cam_pos.device

    @staticmethod
    def make(width: int, height: int, samples_per_pixel: int, max_bounces: int,
             cam_pos, cam_forward, cam_right, cam_up, fov_y: float,
             material: Material, sample_offset: int = 0,
             use_constant_neural_color: bool = False,
             constant_neural_color=(0.8, 0.8, 0.8),
             use_direct_env_color: bool = False,
             direct_env_color=(0.0, 0.0, 0.0),
             scene_scale: float = 1.0,
             outer_shell_min=(0.0, 0.0, 0.0),
             outer_shell_inv_extent=(0.0, 0.0, 0.0),
             device="cuda") -> "RenderParams":
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        with spans.span("sync.params"):
            return RenderParams(
                cam_pos=t(cam_pos), cam_forward=t(cam_forward),
                cam_right=t(cam_right), cam_up=t(cam_up), fov_y=t(fov_y),
                material_row=t(material.scalar_row()),
                use_constant_neural_color=bool(use_constant_neural_color),
                constant_neural_color=t(constant_neural_color),
                use_direct_env_color=bool(use_direct_env_color),
                direct_env_color=t(direct_env_color),
                max_radiance=100.0,
                scene_scale=t(scene_scale),
                sample_offset=int(sample_offset),
                outer_shell_min=t(outer_shell_min),
                outer_shell_inv_extent=t(outer_shell_inv_extent),
                width=width, height=height,
                samples_per_pixel=samples_per_pixel, max_bounces=max_bounces)
