"""Vector helpers over channel-major [3, N] tensors.

Port of `neural_renderer_tpu/ops/linalg.py`. The [3, N] layout is kept at
every public function so the parity tests compare arrays directly; on the
GPU the rows are structure-of-arrays and load coalesced.
"""

from __future__ import annotations

import torch

from ..utils import spans


def splat(v, n: int, device, dtype=torch.float32):
    """Broadcast a length-3 constant (or [3] tensor) to [3, N]."""
    with spans.span("sync.splat"):
        v = torch.as_tensor(v, dtype=dtype, device=device)
    return v[:, None].expand(3, n)


def dot(a, b):
    return (a * b).sum(dim=0)


def cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ], dim=0)


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v, eps: float = 0.0):
    n = length(v)
    if eps > 0.0:
        n = torch.clamp(n, min=eps)
    return v / n[None, :]


def safe_normalize(v, fallback=(0.0, 1.0, 0.0), eps: float = 1e-20,
                   min_len: float = 0.0):
    """normalize(v) where |v| > min_len else the fallback constant."""
    n = length(v)
    with spans.span("sync.safeNormalize"):
        fb = torch.tensor(fallback, dtype=v.dtype, device=v.device)[:, None]
    out = v / torch.clamp(n, min=eps)[None, :]
    return torch.where((n > min_len)[None, :], out, fb)


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def luminance(c):
    """Rec.709 luminance of a [3, N] color."""
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def reflect(wi, n):
    """wi - n * 2 (wi . n)."""
    return wi - n * (2.0 * dot(wi, n))[None, :]


def where3(mask, a, b):
    """Select [3, N] by an [N] mask."""
    return torch.where(mask[None, :], a, b)
