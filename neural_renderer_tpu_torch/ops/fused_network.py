"""Fused MLP of the tcnn-layout shell network: CUDA kernel + PyTorch twin.

Port of `neural_renderer_tpu/ops/fused_network.py` (TPU kernel K7,
`_mlp_kernel`, with `pack_weights` and `apply_fused`), the stand-in for
tiny-cuda-nn's FullyFusedMLP: the hash-grid gathers and SH stay in PyTorch
(models/nbvh.py::encode_inputs), the five bias-free layers run in one
kernel. bf16 operands, f32 accumulation, LeakyReLU 0.01 on the four hidden
layers with each hidden activation re-rounded to bf16, a linear output
layer. Inference only, as the TPU kernel is: training differentiates
`nbvh.mlp_forward`.

Kernel `csrc/fused_mlp.cu` replaces `_mlp_kernel`. It reads the encoded
features as [N, 128] bf16 rows (112 features zero-padded) and writes the 16
meaningful outputs channel-major, [16, N] f32 (the TPU kernel writes
[Npad, 128] and slices). Bound on the card: operations, 65,536
multiply-adds per row (layer 0 at its 112 real inputs), against 320 bytes
of input and output per row. Design: persistent blocks of 8 warps keep the
five weight matrices, bf16, in 140 KB of shared memory; each warp takes 32
rows at a time and runs every layer on the tensor cores with
`mma.sync.m16n8k16` (bf16 in, f32 accumulate), keeping the activations in
registers between layers (an m16n8 accumulator pair is the next layer's
m16k16 operand), so nothing but the input rows and the outputs touches
device memory. `wgmma` and TMA are later work.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from ..models import nbvh

WIDTH = 128
_OUT_DIMS = 16


def pack_input(encoded):
    """Encoded features [N, encoded_dims] -> the kernel's input rows
    [N, 128] bf16, zero-padded."""
    x = torch.nn.functional.pad(encoded, (0, WIDTH - encoded.shape[1]))
    return x.to(torch.bfloat16).contiguous()


def pack_weights(net: nbvh.ShellNetwork):
    """MLP [out, in] matrices -> ([4, 128, 128] bf16 hidden weights with the
    input dims of layer 0 zero-padded to 128, [16, 128] bf16 output
    weight), both [out, in]."""
    w = [m.detach().to(torch.bfloat16) for m in net.mlp]
    w0 = torch.nn.functional.pad(w[0], (0, WIDTH - w[0].shape[1]))
    return torch.stack([w0, *w[1:-1]]).contiguous(), w[-1].contiguous()


def check_kernel_config(cfg: nbvh.NbvhConfig):
    """Raise for a network the kernel was not written for (the reference
    architecture: 128 wide, 4 hidden layers, 16 outputs)."""
    if (cfg.mlp_width != WIDTH or cfg.mlp_hidden_layers != 4
            or cfg.padded_output_dims != _OUT_DIMS
            or cfg.encoded_dims > WIDTH):
        raise ValueError(f"fused_mlp kernel does not take {cfg}")


def apply_fused_twin(net: nbvh.ShellNetwork, x):
    """Plain-PyTorch twin of the kernel on its input rows x [N, 128] bf16:
    `nbvh.mlp_forward` on the real features. Returns [16, N] f32."""
    return nbvh.mlp_forward(list(net.mlp), x[:, :net.config.encoded_dims])


def fused_mlp(net: nbvh.ShellNetwork, x):
    """The MLP on input rows x [N, 128] bf16 (pack_input) -> [16, N] f32.
    CPU tensors run the twin; CUDA tensors launch csrc/fused_mlp.cu."""
    if not x.is_cuda:
        return apply_fused_twin(net, x)
    check_kernel_config(net.config)
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != WIDTH:
        raise ValueError(f"fused_mlp takes [N, {WIDTH}] bf16 rows, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if net.device.type != "cuda":
        raise ValueError("fused_mlp: network weights must be on the GPU")
    return launch(x, *pack_weights(net))


def launch(x, w_hidden, w_out):
    """Launch csrc/fused_mlp.cu on CUDA rows x [N, 128] bf16 and the
    pack_weights operands -> [16, N] f32."""
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty((_OUT_DIMS, n), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("fused_mlp")
    p = cuda_build.ptr
    rc = lib.fused_mlp(p(x), ctypes.c_int(n), p(w_hidden), p(w_out),
                       p(out), cuda_build.stream_of(x))
    cuda_build.check(lib, rc, "fused_mlp")
    apply_fused.launches += 1
    return out


def apply_fused(net: nbvh.ShellNetwork, inputs):
    """Drop-in for the bf16 forward of a tcnn network: PyTorch hash-grid
    encode + SH, then the fused MLP. inputs [12, N] channel-major; returns
    [16, N] f32."""
    with torch.no_grad():
        return fused_mlp(net, pack_input(nbvh.encode_inputs(net, inputs)))


apply_fused.launches = 0
