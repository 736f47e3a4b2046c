"""Fused MLP of the tcnn-layout shell network: CUDA kernel + PyTorch twin.

Port of `neural_renderer_tpu/ops/fused_network.py` (TPU kernel K7,
`_mlp_kernel`, with `pack_weights` and `apply_fused`), the stand-in for
tiny-cuda-nn's FullyFusedMLP: the hash-grid gathers and SH stay in PyTorch
(models/nbvh.py::encode_inputs), the five bias-free layers run in one
kernel. bf16 operands, f32 accumulation, LeakyReLU 0.01 on the four hidden
layers with each hidden activation re-rounded to bf16, a linear output
layer. Inference only, as the TPU kernel is: training differentiates
`nbvh.mlp_forward`.

Kernel `csrc/fused_mlp.cu` replaces `_mlp_kernel`. It takes
`encode_inputs`' output as it is, [N, 112] f32 rows, rounds each feature
to bf16 itself, and writes the 16 outputs channel-major, [16, N] f32 (the
TPU kernel writes [Npad, 128] and slices). Bound on the card
(`bounds.mlp_seconds`): 65,536 multiply-adds a row on the bf16 tensor
cores against 448 B read and 64 B written a row; at 131,072 rows the bytes
decide it. Design (the source's note): persistent blocks of two consumer
warpgroups on `wgmma` and a producer warp that bulk-copies the weight
image once and 64-row input tiles into a two-stage ring; the activations
stay in registers between layers.

The weight image (`pack_weights`; `image_inverse` undoes its layout):
the five matrices, bf16, as the kernel's shared memory holds them and a
`wgmma` descriptor reads them, 135,168 bytes. Each [out, 128 in] matrix
(layer 0 zero-padded from 112 inputs) is K-major: two 64-column halves,
each `out` rows of 128 bytes, in the 128-byte swizzle (16-byte chunk c of
row n stored at chunk c ^ (n % 8)). Layer 0's columns are also reordered within
each 16-column k step (`_layer0_order`) so that the kernel reads each
thread's features of a row in one 16-byte load.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from . import cuda_build
from ..models import nbvh

WIDTH = 128
IN_DIMS = 112
OUT_DIMS = 16
HIDDEN = 4
IMAGE_BYTES = 2 * WIDTH * (HIDDEN * WIDTH + OUT_DIMS)   # 135,168


def check_kernel_config(cfg: nbvh.NbvhConfig):
    """Raise for a network the kernel was not written for (the reference
    architecture: 112 encoded inputs, 4 hidden layers 128 wide, 16
    outputs)."""
    if (cfg.encoded_dims != IN_DIMS or cfg.mlp_width != WIDTH
            or cfg.mlp_hidden_layers != HIDDEN
            or cfg.padded_output_dims != OUT_DIMS):
        raise ValueError(f"fused_mlp kernel does not take {cfg}")


def _layer0_order(w):
    """[rows, 128] -> the same with each 16-column k step reordered: the
    kernel's thread t packs features 4t, 4t+1 as the fragment's columns 2t,
    2t+1 and features 4t+2, 4t+3 as columns 8+2t, 9+2t. Column 8a + 2b + j
    of a step holds feature 4b + 2a + j."""
    return w.reshape(-1, 8, 4, 2, 2).transpose(2, 3).reshape(w.shape)


def _layer0_unorder(w):
    return w.reshape(-1, 8, 2, 4, 2).transpose(2, 3).reshape(w.shape)


def _swizzle_index(device):
    """[8 (row % 8), 8 (stored chunk p)] -> the chunk c stored there:
    c = p ^ (row % 8), its own inverse."""
    r = torch.arange(8, device=device)
    return r[:, None] ^ r[None, :]


def _swizzle(m):
    """[L, R, 128] -> [L, 2, R, 64]: each matrix's two 64-column halves,
    rows of 128 bytes, chunk c of row n at chunk c ^ (n % 8)."""
    L, R = m.shape[:2]
    x = m.reshape(L, R // 8, 8, 2, 8, 8).permute(0, 3, 1, 2, 4, 5)
    idx = _swizzle_index(m.device).view(1, 1, 1, 8, 8, 1).expand(x.shape)
    return torch.gather(x, 4, idx).reshape(L, 2, R, 64)


def _unswizzle(img, L, R):
    x = img.reshape(L, 2, R // 8, 8, 8, 8)
    idx = _swizzle_index(img.device).view(1, 1, 1, 8, 8, 1).expand(x.shape)
    return torch.gather(x, 4, idx).permute(0, 2, 3, 1, 4, 5) \
        .reshape(L, R, WIDTH)


def image_layout(mats):
    """Padded [out, 128 in] matrices (layer 0's inputs zero-padded to 128),
    any dtype -> the kernel's 1-D weight image (module docstring). A pure
    function of its input: `image_inverse` undoes it."""
    hidden = torch.stack([_layer0_order(mats[0]), *mats[1:HIDDEN]])
    return torch.cat([_swizzle(hidden).reshape(-1),
                      _swizzle(mats[HIDDEN][None]).reshape(-1)])


def image_inverse(image):
    """The weight image -> its padded [out, 128 in] matrices."""
    split = HIDDEN * WIDTH * WIDTH
    hidden = _unswizzle(image[:split], HIDDEN, WIDTH)
    return [_layer0_unorder(hidden[0]), *hidden[1:],
            _unswizzle(image[split:], 1, OUT_DIMS)[0]]


def pack_weights(net: nbvh.ShellNetwork):
    """The network's MLP -> the kernel's weight image, [67,584] bf16."""
    w = [m.detach().to(torch.bfloat16) for m in net.mlp]
    w[0] = torch.nn.functional.pad(w[0], (0, WIDTH - w[0].shape[1]))
    return image_layout(w)


# net -> (its MLP tensors, their version counters, their image).
_IMAGES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def weight_image(net: nbvh.ShellNetwork):
    """pack_weights(net), packed again only when a matrix changed: the
    entry holds the tensors themselves (so none is freed and replaced at
    the same address) and compares their version counters, which every
    in-place update (an optimizer step, load_state_dict) bumps. Packing
    is about a dozen small PyTorch ops, 0.29 ms a call on an H100's host
    against a 0.034 ms kernel on 131,072 rows (PERF.md)."""
    mats = tuple(net.mlp)
    versions = tuple(m._version for m in mats)
    hit = _IMAGES.get(net)
    if (hit is None or len(hit[0]) != len(mats)
            or any(a is not b for a, b in zip(hit[0], mats))
            or hit[1] != versions):
        hit = (mats, versions, pack_weights(net))
        _IMAGES[net] = hit
    return hit[2]


def fused_mlp(net: nbvh.ShellNetwork, encoded):
    """The MLP on `encode_inputs`' rows [N, 112] f32 -> [16, N] f32. CPU
    tensors run the twin; CUDA tensors launch csrc/fused_mlp.cu. Raises
    unless `net` is the reference architecture and `encoded` its
    contiguous rows on the network's device."""
    check_kernel_config(net.config)
    if (encoded.dtype != torch.float32 or encoded.dim() != 2
            or encoded.shape[1] != IN_DIMS or not encoded.is_contiguous()):
        raise ValueError(f"fused_mlp takes contiguous [N, {IN_DIMS}] f32 "
                         f"rows, got {tuple(encoded.shape)} {encoded.dtype}")
    if encoded.device != net.device:
        raise ValueError(f"fused_mlp: rows on {encoded.device}, network "
                         f"weights on {net.device}")
    if not encoded.is_cuda:
        return apply_fused_twin(net, encoded)
    return launch(encoded, weight_image(net))


def apply_fused_twin(net: nbvh.ShellNetwork, encoded):
    """Plain-PyTorch twin of the kernel on `encode_inputs`' rows [N, 112]
    f32: `nbvh.mlp_forward`. Returns [16, N] f32."""
    return nbvh.mlp_forward(list(net.mlp), encoded)


def launch(encoded, image):
    """Launch csrc/fused_mlp.cu on CUDA rows [N, 112] f32 and the weight
    image (pack_weights) -> [16, N] f32."""
    cuda_build.check_operands("fused_mlp", [
        ("encoded", encoded, torch.float32), ("image", image,
                                              torch.bfloat16)])
    if image.numel() * 2 != IMAGE_BYTES:
        raise ValueError(f"fused_mlp: the weight image has {image.numel()} "
                         f"values, not {IMAGE_BYTES // 2}")
    if encoded.data_ptr() % 16 or image.data_ptr() % 16:
        raise ValueError("fused_mlp: rows and image must be 16-byte aligned "
                         "(bulk copies)")
    n = encoded.shape[0]
    out = torch.empty((OUT_DIMS, n), dtype=torch.float32,
                      device=encoded.device)
    if n == 0:
        return out
    lib = cuda_build.load("fused_mlp")
    p = cuda_build.ptr
    rc = lib.fused_mlp(p(encoded), ctypes.c_int(n), p(image), p(out),
                       cuda_build.stream_of(encoded))
    cuda_build.check(lib, rc, "fused_mlp")
    apply_fused.launches += 1
    return out


def apply_fused(net: nbvh.ShellNetwork, inputs):
    """Drop-in for the bf16 forward of a tcnn network: PyTorch hash-grid
    encode + SH, then the fused MLP. inputs [12, N] channel-major; returns
    [16, N] f32."""
    with torch.no_grad():
        return fused_mlp(net, nbvh.encode_inputs(net, inputs))


apply_fused.launches = 0
