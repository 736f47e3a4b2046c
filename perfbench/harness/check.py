"""What decides `correct`: the images the timed calls returned, at pixels
drawn from the seed, against the plain reference's images of the same
samples.

Two of the window's calls are compared: one drawn from the seed among its
first eight, and the last. The reference renders every sample those
images hold (for an accumulating view, every frame rendered so far) at
the drawn pixels, accumulates them as the renderer does and encodes them
to sRGB u8. The numbers compared, each over the drawn pixels' channels
and the worse of the two images:
  mean_abs_u8   the mean absolute difference, in u8 levels;
  share_off_8   the share of channels that differ by more than 8 levels.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("mean_abs_u8", "share_off_8")
# The compared early call is drawn among the window's first calls.
FIRST_CALLS = 8


def draw(seed: int, n_pixels: int, check_pixels: int, first_calls: int):
    """(pixel ids [P] sorted, the index among the window's first calls of
    the call to compare) drawn from the seed, apart from the traffic's
    draws."""
    rng = np.random.default_rng([seed % (1 << 63), 1])
    pix = np.sort(rng.choice(n_pixels, size=check_pixels, replace=False))
    return pix, int(rng.integers(0, first_calls))


def pick(img: np.ndarray, pix: np.ndarray) -> np.ndarray:
    """[P, 3] u8 of an [H, W, 3] image at flat pixel ids."""
    return img.reshape(-1, 3)[pix].copy()


def compare(program: list, reference: list) -> dict:
    """The numbers over pairs of [P, 3] u8 images: the worse of each."""
    out = {k: 0.0 for k in NUMBERS}
    for a, b in zip(program, reference):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        out["mean_abs_u8"] = max(out["mean_abs_u8"], float(diff.mean()))
        out["share_off_8"] = max(out["share_off_8"],
                                 float((diff > 8).mean()))
    return out


def reference_images(config_path: str, cell, calls: list, pix, device,
                     precision: str = "f32", low_geometry: bool = False):
    """The reference's [P, 3] u8 images of the given call indices (0 = the
    first call of the run, warm-up included) at pixel ids `pix`."""
    import torch

    from reference.frame import Scene, View, render_samples
    from reference.vec import srgb_u8
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        scene = Scene.from_file(config_path, device, cell.neural, precision)
        c = cell.camera

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        view = View(cell.width, cell.height, cell.bounces,
                    {"pos": t(c.pos), "forward": t(c.forward),
                     "right": t(c.right), "up": t(c.up), "fov_y": t(c.fov_y)})
        p = torch.as_tensor(pix, dtype=torch.int64, device=device)
        spp = cell.spp
        # Calls whose samples the compared images hold.
        span = range(max(calls) + 1) if cell.accumulates() else sorted(
            set(calls))
        streams = [s for k in span for s in cell.streams(k)]
        pix_all = p.repeat(len(streams))
        stream_all = torch.as_tensor(streams, dtype=torch.int64,
                                     device=device).repeat_interleave(
                                         p.numel())
        rad = render_samples(scene, view, pix_all, stream_all, low_geometry)
        rad = rad.reshape(3, len(span), spp, p.numel())
        f32 = torch.float32
        out = {}
        accum = torch.zeros((3, p.numel()), dtype=f32, device=device)
        for i, k in enumerate(span):
            batch = rad[:, i].sum(dim=1)
            if cell.accumulates():
                accum = accum + batch
                scale = 1.0 / (torch.tensor(float(k * spp), dtype=f32,
                                            device=device)
                               + torch.tensor(float(spp), dtype=f32,
                                              device=device))
            else:
                accum = torch.zeros_like(batch) + batch
                scale = 1.0 / torch.tensor(float(spp), dtype=f32,
                                           device=device)
            if k in calls:
                out[k] = srgb_u8(accum * scale).T.cpu().numpy()
        return [out[k] for k in calls]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def control_numbers(config_path: str, traffic: dict, spec: dict, seed: int,
                    device) -> dict:
    """The numbers of the cell's control: the reference in the program's
    place, computed a precision lower than the configuration states (the
    cell file's "control": "network_fp8", the network's tables, weights
    and layer inputs in float8 e4m3 where the port serves bf16, or
    "geometry_bf16", every ray-triangle test in bfloat16 where the frame
    states float32), against the reference, for the calls a run compares
    (its window holding the cell file's "window_calls")."""
    from .cells import Cell
    cell = Cell(config_path, traffic, seed, device, program=False)
    pix, k_rel = draw(seed, cell.width * cell.height,
                      int(spec["check_pixels"]), FIRST_CALLS)
    warm = int(traffic["warmup_calls"])
    calls = sorted({warm + k_rel, warm + int(spec["window_calls"]) - 1})
    control = spec["control"]
    low = reference_images(config_path, cell, calls, pix, device,
                           precision="fp8" if control == "network_fp8"
                           else "f32",
                           low_geometry=control == "geometry_bf16")
    ref = reference_images(config_path, cell, calls, pix, device)
    return compare(low, ref)
