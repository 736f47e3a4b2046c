"""The neural shell-intersection network, lane-grid variant.

Port of `neural_renderer_tpu/models/nbvh.py`: `NbvhConfig`, `init_params`,
`encode_inputs` (lane branch), `mlp_forward` and `apply`. The network is a
`ShellNetwork` module holding the lane tables and the bias-free MLP
([out, in] matrices, as in the JAX pytree):

  input [entry.xyz | exit.xyz | mid.xyz | dir01.xyz] (12, channel-major)
  -> 3 x lane grid (8 levels x 4 features) + SH degree 4 = 112 features
  -> 4 hidden LeakyReLU layers of width 128 -> 16 outputs
     (0 presence logit, 1 distance, 2:5 normal, 5:8 color).

The tcnn-layout grid and the flat FP16 blob IO are not ported yet.

Rendering runs without autograd: the parameters are built with
`requires_grad=False`, and the trainer (train/trainer.py) switches them on
with `net.requires_grad_(True)`; its gradients come from
ops/lane_grid_train_kernel.py::apply_train, not from autograd through
`apply`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from .encoding import SH_DIM, sh_encode_features
from .lane_grid import init_lane_tables, lane_encode_features

LEAKY_SLOPE = 0.01  # tcnn LeakyReLU negative slope


@dataclass(frozen=True)
class NbvhConfig:
    log2_hashmap_size: int = 14
    base_resolution: int = 16
    n_levels: int = 8
    n_features: int = 4
    per_level_scale: float = 2.0
    point_count: int = 3
    mlp_width: int = 128
    mlp_hidden_layers: int = 4
    output_dims: int = 5
    padded_output_dims: int = 16
    grid_type: str = "lane"
    lane_sublanes: int = 8
    lane_entry_pack: int = 2

    @staticmethod
    def from_network_config(nn_config) -> "NbvhConfig":
        """The network of a scene config's `neural_network` block
        (config.py::NeuralNetworkConfig)."""
        return NbvhConfig(log2_hashmap_size=nn_config.log2_hashmap_size,
                          base_resolution=nn_config.base_resolution,
                          grid_type=nn_config.grid_type,
                          lane_sublanes=nn_config.lane_sublanes,
                          lane_entry_pack=nn_config.lane_entry_pack)

    @property
    def input_dims(self) -> int:
        return self.point_count * 3 + 3

    @property
    def encoded_dims(self) -> int:
        return self.point_count * self.n_levels * self.n_features + SH_DIM


class ShellNetwork(nn.Module):
    """Lane tables + MLP weights of one shell network. Frozen when built;
    `requires_grad_(True)` makes it trainable."""

    def __init__(self, config: NbvhConfig, lane: torch.Tensor,
                 mlp: list[torch.Tensor]):
        super().__init__()
        if config.grid_type != "lane":
            raise NotImplementedError(
                "only lane-grid networks are ported (grid_type='lane')")
        self.config = config
        self.lane = nn.Parameter(lane, requires_grad=False)
        self.mlp = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in mlp])

    def forward(self, inputs, active=None):
        return apply(self, inputs, active=active)


def init_params(config: NbvhConfig, generator: torch.Generator,
                device="cuda") -> ShellNetwork:
    """Random init: tables uniform(-1e-4, 1e-4) (tcnn default), MLP He
    normal, drawn from `generator` on the CPU and moved to `device`."""
    lane = init_lane_tables(config.point_count, config.n_levels,
                            config.n_features, config.lane_sublanes,
                            config.lane_entry_pack, generator, device)
    dims = ([config.encoded_dims]
            + [config.mlp_width] * config.mlp_hidden_layers
            + [config.padded_output_dims])
    mlp = []
    for i in range(len(dims) - 1):
        std = math.sqrt(2.0 / dims[i])
        w = torch.randn((dims[i + 1], dims[i]), generator=generator,
                        dtype=torch.float32) * std
        mlp.append(w.to(device))
    return ShellNetwork(config, lane, mlp)


def encode_inputs(net: ShellNetwork, inputs, tables=None):
    """inputs [12, N] channel-major -> encoded [N, encoded_dims] f32.
    `tables` overrides the module's lane tables (the kernel twin passes the
    bf16-rounded ones)."""
    cfg = net.config
    feats = lane_encode_features(net.lane if tables is None else tables,
                                 inputs, cfg.base_resolution,
                                 cfg.per_level_scale)
    p3 = cfg.point_count * 3
    feats.extend(sh_encode_features(inputs[p3:p3 + 3]))
    return torch.stack(feats, dim=-1)


def mlp_forward(mlp_params, x):
    """Bias-free LeakyReLU MLP with bf16 operands and f32 accumulation:
    every operand is rounded to bf16, every product summed in f32, each
    hidden activation re-rounded to bf16; the output layer is linear.
    x: [N, encoded]; returns channel-major [padded_out, N] f32."""
    h = x.to(torch.bfloat16).to(torch.float32)
    n_layers = len(mlp_params)
    for i, w in enumerate(mlp_params):
        wb = w.to(torch.bfloat16).to(torch.float32)
        h = h @ wb.T
        if i < n_layers - 1:
            h = torch.where(h > 0, h, LEAKY_SLOPE * h)
            h = h.to(torch.bfloat16).to(torch.float32)
    return h.T.contiguous()


def apply(net: ShellNetwork, inputs, active=None):
    """Full forward: [12, N] -> [padded_output_dims, N] f32 through the fused
    lane-grid kernel (its twin for CPU tensors). `active` ([N] bool) lets
    128-ray blocks without an active ray output zeros; callers mask those
    lanes, as the shell march does."""
    from ..ops.lane_grid_kernel import forward_lane
    return forward_lane(net, inputs, active=active)
