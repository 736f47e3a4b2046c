"""K10: the Disney bounce sampler in one CUDA kernel.

`csrc/sample_bounce.cu` computes, one thread a ray, what its PyTorch twin
`render/pathtrace.py::sample_bounce_twin` computes: the RNG draws, the
primary ray again on the first bounce, the shading frame, one lobe's
direction, the three-lobe mixture pdf, the Disney evaluation and the BRDF
weight, and the flags of the paths still active. It replaces no Pallas kernel (the JAX
package leaves the sampler to XLA's fusion); the source's note says why it
was added and what bounds it. `render/pathtrace.py::sample_bounce` is the
stage that calls it.

The kernel reads the camera basis, the field of view, the scene scale and
the global material row from one small device vector (`pack_operands`),
so no host constant is copied and nothing waits for the device.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import spans
from . import cuda_build

# pack_operands' layout: csrc/sample_bounce.cu's SB_* offsets.
FORWARD, RIGHT, UP, FOV_Y, SCENE_SCALE, MATERIAL = 0, 3, 6, 9, 10, 11


def pack_operands(params) -> torch.Tensor:
    """The kernel's operands of `params` (render/params.py), f32 on their
    device: cam_forward, cam_right, cam_up, fov_y, scene_scale and the
    material row, at the offsets above. One device copy, no host sync."""
    return torch.cat([params.cam_forward, params.cam_right, params.cam_up,
                      params.fov_y.reshape(1), params.scene_scale.reshape(1),
                      params.material_row]).to(torch.float32)


def sample_bounce(params, pixel_idx, sample_of, position, normal, albedo,
                  material_params, hit, path_active, incoming=None):
    """One launch of K10 on N rays: pixel_idx, sample_of [N] int64;
    position, normal, albedo, material_params [3, N] f32; hit, path_active
    [N] bool; incoming [3, N] f32, or None on the first bounce (the
    primary ray is regenerated from the RNG stream). Returns (origin,
    direction, pdf, brdf_weight, active): the bounce rays, zero where the
    sample is invalid, and path_active & hit & (pdf > 0). CUDA tensors
    only; a strided operand is made contiguous here."""
    n = hit.shape[0]
    f32 = torch.float32
    (pixel_idx, sample_of, position, normal, albedo, material_params, hit,
     path_active) = (x.contiguous() for x in (
         pixel_idx, sample_of, position, normal, albedo, material_params,
         hit, path_active))
    if incoming is not None:
        incoming = incoming.contiguous()
    rows = [("position", position), ("normal", normal), ("albedo", albedo),
            ("material_params", material_params)]
    if incoming is not None:
        rows.append(("incoming", incoming))
    for name, x in rows:
        if tuple(x.shape) != (3, n):
            raise ValueError(f"sample_bounce: {name} must be [3, {n}], "
                             f"got {tuple(x.shape)}")
    for name, x in (("pixel_idx", pixel_idx), ("sample_of", sample_of),
                    ("path_active", path_active)):
        if tuple(x.shape) != (n,):
            raise ValueError(f"sample_bounce: {name} must be [{n}], got "
                             f"{tuple(x.shape)}")
    ops = pack_operands(params)
    operands = [("pixel_idx", pixel_idx, torch.int64),
                ("sample_of", sample_of, torch.int64),
                *((name, x, f32) for name, x in rows),
                ("hit", hit, torch.bool),
                ("path_active", path_active, torch.bool),
                ("operands", ops, f32)]
    cuda_build.check_operands("sample_bounce", operands)
    dev = hit.device
    if any(x.device != dev for _, x, _ in operands):
        raise ValueError("sample_bounce: every operand must be on one device")
    lib = cuda_build.load("sample_bounce")
    origin = torch.empty((3, n), dtype=f32, device=dev)
    direction = torch.empty((3, n), dtype=f32, device=dev)
    pdf = torch.empty((n,), dtype=f32, device=dev)
    weight = torch.empty((3, n), dtype=f32, device=dev)
    active = torch.empty((n,), dtype=torch.bool, device=dev)
    p = cuda_build.ptr
    rc = lib.nr_sample_bounce(
        ctypes.c_longlong(n), p(pixel_idx), p(sample_of), p(position),
        p(normal), p(albedo), p(material_params), p(hit), p(path_active),
        ctypes.c_void_p(None) if incoming is None else p(incoming), p(ops),
        ctypes.c_int(params.width), ctypes.c_int(params.height),
        ctypes.c_uint(int(params.sample_offset) & 0xFFFFFFFF), p(origin),
        p(direction), p(pdf), p(weight), p(active),
        cuda_build.stream_of(hit))
    cuda_build.check(lib, rc, "sample_bounce")
    sample_bounce.launches += 1
    spans.count("sample_kernel_rays", n)
    return origin, direction, pdf, weight, active


sample_bounce.launches = 0
