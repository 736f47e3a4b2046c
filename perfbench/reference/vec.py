"""Plain float32 helpers of the reference frame: [3, N] vector algebra,
the counter-based wang-hash RNG, the jittered pinhole camera, the
procedural sky and the sRGB encode.

Written from the reference renderer's definitions (Alehandreus/
neural-renderer: `rng.cuh`, `camera.cuh`, `envmap.cuh`), independent of
the program under test. The RNG state is carried as int64 masked to 32
bits, which reproduces wrapping uint32 arithmetic exactly.
"""

from __future__ import annotations

import torch

# Material scalar-row layout (the renderer's per-material constant row).
P_BASE_R, P_BASE_G, P_BASE_B = 0, 1, 2
P_METALLIC = 3
P_ROUGHNESS = 4
P_SPECULAR = 5
P_SPECULAR_TINT = 6
P_ANISOTROPY = 7
P_SHEEN = 8
P_SHEEN_TINT = 9
P_CLEARCOAT = 10
P_CLEARCOAT_GLOSS = 11
P_EMISSION_R, P_EMISSION_G, P_EMISSION_B = 12, 13, 14
P_EMISSION_SCALE = 15
P_IOR = 16
P_SPEC_TRANS = 17
NUM_SCALARS = 18

_MASK = 0xFFFFFFFF


def dot(a, b):
    return (a * b).sum(dim=0)


def cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]], dim=0)


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v, eps: float = 0.0):
    n = length(v)
    if eps > 0.0:
        n = torch.clamp(n, min=eps)
    return v / n[None, :]


def safe_normalize(v, eps: float = 1e-20, min_len: float = 0.0):
    """normalize(v) where |v| > min_len, else (0, 1, 0)."""
    n = length(v)
    fb = torch.tensor((0.0, 1.0, 0.0), dtype=v.dtype, device=v.device)
    out = v / torch.clamp(n, min=eps)[None, :]
    return torch.where((n > min_len)[None, :], out, fb[:, None])


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def luminance(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def reflect(wi, n):
    return wi - n * (2.0 * dot(wi, n))[None, :]


def where3(mask, a, b):
    return torch.where(mask[None, :], a, b)


def splat(v, n: int, device):
    return torch.as_tensor(v, dtype=torch.float32,
                           device=device)[:, None].expand(3, n)


def wang_hash(x):
    x = x & _MASK
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _MASK
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _MASK
    return x ^ (x >> 15)


def init_rng(pixel_idx, stream):
    """The sample stream of (pixel, stream): stream is the sample offset
    plus the sample index (plus the bounce for Russian roulette), so
    seed = pixel * 9781 + (stream + 1) * 6271, wang-hashed."""
    seed = ((pixel_idx & _MASK) * 9781
            + (((stream + 1) & _MASK) * 6271)) & _MASK
    return wang_hash(seed)


def rand01(state):
    state = wang_hash(state)
    return state, (state & 0x00FFFFFF).to(torch.float32) * (1.0 / 16777216.0)


def camera_rays(px, py, state, cam, width: int, height: int):
    """Jittered pinhole rays through pixels (px, py): two draws, x then y.
    cam: dict of [3] float32 tensors pos, forward, right, up and the
    scalar tensor fov_y. Returns (state, origins [3, N], dirs [3, N])."""
    f32 = torch.float32
    dev = px.device
    state, jx = rand01(state)
    state, jy = rand01(state)
    aspect = torch.tensor(width / height, dtype=f32, device=dev)
    u = (px.to(f32) + jx) / torch.tensor(width, dtype=f32, device=dev)
    v = 1.0 - (py.to(f32) + jy) / torch.tensor(height, dtype=f32, device=dev)
    u = u * 2.0 - 1.0
    v = v * 2.0 - 1.0
    tan_half = torch.tan(cam["fov_y"] * 0.5)
    d = (cam["forward"][:, None]
         + cam["right"][:, None] * (u * aspect * tan_half)[None, :]
         + cam["up"][:, None] * (v * tan_half)[None, :])
    d = d / torch.sqrt((d * d).sum(dim=0, keepdim=True))
    return state, cam["pos"][:, None].expand_as(d).contiguous(), d


def sky(dirs, max_radiance: float = 100.0):
    """The procedural sky (no environment map): white at the nadir to
    (0.5, 0.7, 1.0) at the zenith, clamped at max_radiance."""
    n = dirs.shape[1]
    t = 0.5 * (dirs[1] + 1.0)
    c = lerp(splat([1.0, 1.0, 1.0], n, dirs.device),
             splat([0.5, 0.7, 1.0], n, dirs.device), t[None, :])
    return torch.clamp(torch.clamp(c, max=100.0), max=max_radiance)


def srgb_u8(color):
    """Linear RGB -> sRGB uint8, truncating."""
    v = torch.clamp(color, min=0.0)
    low = 12.92 * v
    high = 1.055 * torch.pow(torch.clamp(v, min=1e-12), 1.0 / 2.4) - 0.055
    s = torch.clamp(torch.where(v <= 0.0031308, low, high), max=1.0)
    return (s * 255.0).to(torch.uint8)
