"""The neural shell-intersection network, lane-grid and tcnn-layout.

Port of `neural_renderer_tpu/models/nbvh.py`: `NbvhConfig`, `init_params`,
`encode_inputs`, `mlp_forward`, `apply` and the flat FP16 blob IO. The
network is a `ShellNetwork` module holding its grid (the lane tables, or
one tcnn-layout hash grid shared by the three encoder slots) and the
bias-free MLP ([out, in] matrices, as in the JAX pytree):

  input [entry.xyz | exit.xyz | mid.xyz | dir01.xyz] (12, channel-major)
  -> 3 x grid (8 levels x 4 features) + SH degree 4 = 112 features
  -> 4 hidden LeakyReLU layers of width 128 -> 16 outputs
     (0 presence logit, 1 distance, 2:5 normal, 5:8 color).

`apply` runs lane networks through the fused lane-grid kernel
(ops/lane_grid_kernel.py) and tcnn networks through the PyTorch hash-grid
encode and the fused MLP kernel (ops/fused_network.py), in chunks of
ENC_CHUNK segments.

Rendering runs without autograd: the parameters are built with
`requires_grad=False`, and the trainer (train/trainer.py) switches them on
with `net.requires_grad_(True)`. Lane gradients come from
ops/lane_grid_train_kernel.py::apply_train; tcnn gradients from autograd
through `encode_inputs` and `mlp_forward`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..utils import spans
from .encoding import (SH_DIM, HashGridConfig, hashgrid_encode_features,
                       init_hashgrid, sh_encode_features)
from .lane_grid import init_lane_tables, lane_encode_features

LEAKY_SLOPE = 0.01  # tcnn LeakyReLU negative slope

# Segments per tcnn encode + MLP pass: the [N, 112] feature stack and the
# corner temporaries of the encode take ~2 KB per segment, so a 1080p x 8
# batch (16.6 M segments) runs in chunks.
ENC_CHUNK = 1 << 21


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
    # "lane" (the default here) or "tcnn"; scene configs choose through
    # from_network_config.
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
    def grid(self) -> HashGridConfig:
        return HashGridConfig(
            n_levels=self.n_levels, n_features=self.n_features,
            log2_hashmap_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution,
            per_level_scale=self.per_level_scale)

    @property
    def encoded_dims(self) -> int:
        return self.point_count * self.n_levels * self.n_features + SH_DIM

    @property
    def mlp_dims(self) -> list[int]:
        return ([self.encoded_dims] + [self.mlp_width] * self.mlp_hidden_layers
                + [self.padded_output_dims])

    @property
    def mlp_n_params(self) -> int:
        w, e = self.mlp_width, self.encoded_dims
        return (w * e + (self.mlp_hidden_layers - 1) * w * w
                + self.padded_output_dims * w)

    @property
    def hg_n_params(self) -> int:
        return self.grid.n_params

    @property
    def n_params(self) -> int:
        return self.mlp_n_params + self.point_count * self.hg_n_params


class ShellNetwork(nn.Module):
    """Grid + MLP weights of one shell network. Lane networks hold `lane`
    ([P, L, F, S, (pack,) 128]); tcnn networks hold `grid`, the per-level
    [E_l, F] tables of one hash grid that every encoder slot shares (the
    structure the reference's flat blob implies). Frozen when built;
    `requires_grad_(True)` makes it trainable."""

    def __init__(self, config: NbvhConfig, mlp: list[torch.Tensor],
                 lane: torch.Tensor | None = None, grid=None):
        super().__init__()
        given = {"lane": lane is not None, "tcnn": grid is not None}
        if config.grid_type not in given or \
                [k for k, v in given.items() if v] != [config.grid_type]:
            raise ValueError("a ShellNetwork takes `lane` for grid_type "
                             "'lane' or `grid` for 'tcnn', not both (got "
                             f"'{config.grid_type}')")
        self.config = config
        self.lane = None if lane is None else nn.Parameter(
            lane, requires_grad=False)
        self.grid = None if grid is None else nn.ParameterList(
            [nn.Parameter(t, requires_grad=False) for t in grid])
        self.mlp = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in mlp])

    @property
    def device(self) -> torch.device:
        return self.mlp[0].device

    def forward(self, inputs, active=None):
        return apply(self, inputs, active=active)


def init_params(config: NbvhConfig, generator: torch.Generator,
                device="cuda") -> ShellNetwork:
    """Random init: tables uniform(-1e-4, 1e-4) (tcnn default), MLP He
    normal, drawn from `generator` on the CPU and moved to `device`. A tcnn
    network gets one hash grid for all encoder slots, so trained weights
    survive the blob export."""
    lane = grid = None
    if config.grid_type == "lane":
        lane = init_lane_tables(config.point_count, config.n_levels,
                                config.n_features, config.lane_sublanes,
                                config.lane_entry_pack, generator, device)
    else:
        grid = init_hashgrid(config.grid, generator, device)
    dims = config.mlp_dims
    mlp = []
    for i in range(len(dims) - 1):
        std = math.sqrt(2.0 / dims[i])
        w = torch.randn((dims[i + 1], dims[i]), generator=generator,
                        dtype=torch.float32) * std
        mlp.append(w.to(device))
    return ShellNetwork(config, mlp, lane=lane, grid=grid)


def encode_inputs(net: ShellNetwork, inputs, tables=None):
    """inputs [12, N] channel-major -> encoded [N, encoded_dims] f32.
    `tables` overrides a lane network's tables (the kernel twin passes the
    bf16-rounded ones)."""
    cfg = net.config
    if cfg.grid_type == "lane":
        feats = lane_encode_features(net.lane if tables is None else tables,
                                     inputs, cfg.base_resolution,
                                     cfg.per_level_scale)
    else:
        feats = []
        for p in range(cfg.point_count):
            feats.extend(hashgrid_encode_features(
                list(net.grid), inputs[p * 3:(p + 1) * 3], cfg.grid))
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
    """Full forward: [12, N] -> [padded_output_dims, N] f32 (the kernels on
    CUDA tensors, their twins on CPU tensors). Lane networks: the fused
    lane-grid kernel, where `active` ([N] bool) lets 128-ray blocks without
    an active ray output zeros (callers mask those lanes, as the shell march
    does). tcnn networks: hash-grid encode + the fused MLP kernel, ENC_CHUNK
    segments at a time; `active` is ignored, as on the JAX XLA path.
    While traced, the live rows (`active`'s count, else N) add to the
    `net_rows` counter (utils/spans.py)."""
    with spans.span("neuralForward"):
        spans.count("net_rows",
                    inputs.shape[1] if active is None else active.sum())
        if net.config.grid_type == "lane":
            from ..ops.lane_grid_kernel import forward_lane
            return forward_lane(net, inputs, active=active)
        from ..ops import fused_network
        n = inputs.shape[1]
        if n <= ENC_CHUNK:
            return fused_network.apply_fused(net, inputs)
        out = torch.empty((net.config.padded_output_dims, n),
                          dtype=torch.float32, device=inputs.device)
        for s in range(0, n, ENC_CHUNK):
            out[:, s:s + ENC_CHUNK] = fused_network.apply_fused(
                net, inputs[:, s:s + ENC_CHUNK])
        return out


# ---------------------------------------------------------------------------
# Flat FP16 blob IO (reference checkpoint format)
# ---------------------------------------------------------------------------

def _split_grid_blob(flat: np.ndarray, config: NbvhConfig):
    """Flat per-grid params -> per-level [E_l, F] arrays (level-major,
    feature-interleaved, tcnn layout)."""
    grid = config.grid
    tables = []
    cursor = 0
    for level in range(grid.n_levels):
        n = grid.level_entries(level)
        chunk = flat[cursor:cursor + n * grid.n_features]
        tables.append(chunk.reshape(n, grid.n_features))
        cursor += n * grid.n_features
    return tables


def _split_mlp_blob(flat: np.ndarray, config: NbvhConfig):
    dims = config.mlp_dims
    mats = []
    cursor = 0
    for i in range(len(dims) - 1):
        rows, cols = dims[i + 1], dims[i]
        mats.append(flat[cursor:cursor + rows * cols].reshape(rows, cols))
        cursor += rows * cols
    return mats


def load_flat_blob(path: str, config: NbvhConfig, device="cuda"
                   ) -> ShellNetwork:
    """Load the reference's flat FP16 checkpoint in the order its loader
    reads by default (swap_param_order): [hg | mlp]; fp16 -> f32. The
    single hash grid block is shared by all point_count encoder slots (the
    reference tiles one copy into each slot)."""
    if config.grid_type == "lane":
        raise ValueError(
            "The reference flat-FP16 blob encodes the tcnn grid layout; "
            "lane-grid networks checkpoint as .npz (train/trainer.py).")
    raw = np.fromfile(path, dtype=np.float16)
    expected = config.mlp_n_params + config.hg_n_params
    if raw.size != expected:
        raise ValueError(
            f"Weights size mismatch (got {raw.size} halfs, expected "
            f"{expected}). Format: [hg | mlp] (FP16).")
    raw = raw.astype(np.float32)
    hg, mlp = raw[:config.hg_n_params], raw[config.hg_n_params:]
    grid = [torch.as_tensor(t, device=device)
            for t in _split_grid_blob(hg, config)]
    mlp_mats = [torch.as_tensor(m, device=device)
                for m in _split_mlp_blob(mlp, config)]
    return ShellNetwork(config, mlp_mats, grid=grid)


def save_flat_blob(path: str, net: ShellNetwork):
    """Export to the reference's flat FP16 format, [hg | mlp]."""
    if net.grid is None:
        raise ValueError(
            "Only tcnn-layout networks export to the reference blob format; "
            "lane-grid networks checkpoint as .npz (train/trainer.py).")
    hg = np.concatenate([t.detach().cpu().numpy().astype(np.float32)
                         .reshape(-1) for t in net.grid])
    mlp = np.concatenate([w.detach().cpu().numpy().astype(np.float32)
                          .reshape(-1) for w in net.mlp])
    np.concatenate([hg, mlp]).astype(np.float16).tofile(path)
