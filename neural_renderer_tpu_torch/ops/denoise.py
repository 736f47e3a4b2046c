"""Joint bilateral denoiser.

Port of `neural_renderer_tpu/ops/denoise.py`, same parameters: an 11x11
window (radius 5), spatial sigma 3, normal similarity dot^64, albedo
Gaussian sigma 0.1. The input is the running linear-HDR accumulation
buffer and the sample-0 primary-hit guide normals and albedo; the output is
the denoised sRGB u8 image.

Plain PyTorch, as the reference is plain array code: the 121 taps are a
static loop of multiply-adds over shifted views of padded channel-major
[3, H, W] tensors. The u8 [H, W, 3] image is made only at the output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .srgb import encode_srgb_u8

DENOISE_RADIUS = 5
SIGMA_SPATIAL = 3.0
NORMAL_ALPHA = 64.0
SIGMA_ALBEDO = 0.1


def _bilateral_core(color_p, normals_p, albedo_p, valid_p, h: int, w: int):
    """Stencil core on pre-padded tensors: *_p are [3, h+2r, w+2r]
    (valid_p [h+2r, w+2r]); rows and columns outside the true image carry
    valid=0 and get zero tap weight (the window clipping). Returns the
    denoised linear-HDR centre [3, h, w].

    The padded rows need not be zero: a stripe of a larger image may fill
    them with its neighbours' real rows (valid=1), which is how the
    stencil sees interior rows of the whole image."""
    r = DENOISE_RADIUS
    inv_ss2 = 1.0 / (2.0 * SIGMA_SPATIAL * SIGMA_SPATIAL)
    inv_sa2 = 1.0 / (2.0 * SIGMA_ALBEDO * SIGMA_ALBEDO)

    color = color_p[:, r:r + h, r:r + w]
    guide_normals = normals_p[:, r:r + h, r:r + w]
    guide_albedo = albedo_p[:, r:r + h, r:r + w]

    weighted = torch.zeros_like(color)
    total_w = torch.zeros(color.shape[1:], dtype=color.dtype,
                          device=color.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            ys = slice(r + dy, r + dy + h)
            xs = slice(r + dx, r + dx + w)
            w_spatial = math.exp(-(dx * dx + dy * dy) * inv_ss2)
            ndot = torch.clamp((guide_normals * normals_p[:, ys, xs]).sum(0),
                               0.0, 1.0)
            w_normal = torch.pow(ndot, NORMAL_ALPHA)
            da = albedo_p[:, ys, xs] - guide_albedo
            w_albedo = torch.exp(-(da * da).sum(0) * inv_sa2)
            wgt = w_spatial * w_normal * w_albedo * valid_p[ys, xs]
            weighted = weighted + color_p[:, ys, xs] * wgt[None]
            total_w = total_w + wgt

    return torch.where(total_w[None] > 0.0,
                       weighted / torch.clamp(total_w, min=1e-20)[None],
                       color)


def bilateral_denoise(accum, accum_count, guide_normals, guide_albedo):
    """accum: [3, H, W] linear-HDR sums; accum_count: the number of
    samples in them (a number or a scalar tensor); guides [3, H, W].
    Returns the denoised u8 image [H, W, 3]."""
    count = torch.as_tensor(accum_count, dtype=torch.float32,
                            device=accum.device)
    color = accum * (1.0 / torch.clamp(count, min=1.0))
    r = DENOISE_RADIUS
    h, w = color.shape[1:]

    def pad(x):
        return F.pad(x, (r, r, r, r))

    valid = pad(torch.ones((1, h, w), dtype=color.dtype,
                           device=color.device))[0]
    out = _bilateral_core(pad(color), pad(guide_normals), pad(guide_albedo),
                          valid, h, w)
    return encode_srgb_u8(out).permute(1, 2, 0).contiguous()
