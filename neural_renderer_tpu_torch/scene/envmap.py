"""Environment maps: Radiance .hdr (RGBE + RLE), EXR, PNG and JPEG loading,
and the device container.

Port of `neural_renderer_tpu/scene/envmap.py`: `decode_rgbe`, `load_hdr`
(the native RLE decoder `csrc/hdr_rle.cpp`, built at first use by
`utils/native.py`, with the Python decoder where no host compiler exists),
`_load_exr` (this package's own reader, `scene/exr.py`; no fallback decoder,
so a file it refuses raises), `_load_ldr` (PNG through
`metrics/image_io.decode_png`, JPEG through `metrics/jpeg.decode_jpeg`),
`EnvironmentMap` and `EnvmapArrays` -> `EnvironmentTensors`. A map is
channel-major [3, H*W]; an invalid one selects the procedural sky.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch


class EnvmapLoadError(RuntimeError):
    pass


def decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """[.., 4] uint8 RGBE -> [.., 3] float32."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e == 0, 0.0,
                     np.ldexp(1.0, e - (128 + 8))).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


_RLE = {}


def _load_rle_native():
    """ctypes handle to the library built from csrc/hdr_rle.cpp, or None
    (no host compiler): the Python decoder then runs."""
    if "lib" in _RLE:
        return _RLE["lib"]
    from ..utils.native import ensure_native_lib
    lib = None
    path = ensure_native_lib("hdr_rle.cpp")
    if path is not None:
        lib = ctypes.CDLL(path)
        lib.decode_hdr_rle.restype = ctypes.c_longlong
        lib.decode_hdr_rle.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    _RLE["lib"] = lib
    return lib


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr with RLE scanlines -> float32 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: lines until blank; require the 32-bit_rle_rgbe format.
    pos = 0
    format_ok = False
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            raise EnvmapLoadError("Truncated HDR header.")
        line = data[pos:nl]
        pos = nl + 1
        if not line:
            break
        if line.startswith(b"FORMAT=") and b"32-bit_rle_rgbe" in line:
            format_ok = True
    if not format_ok:
        raise EnvmapLoadError(
            "Unsupported HDR format (expected 32-bit_rle_rgbe).")

    nl = data.find(b"\n", pos)
    if nl < 0:
        raise EnvmapLoadError("Missing HDR resolution line.")
    parts = data[pos:nl].split()
    pos = nl + 1
    if len(parts) != 4 or parts[0] != b"-Y" or parts[2] != b"+X":
        raise EnvmapLoadError("Invalid HDR resolution line.")
    height, width = int(parts[1]), int(parts[3])
    if width <= 0 or height <= 0:
        raise EnvmapLoadError("Invalid HDR dimensions.")

    pixels = np.zeros((height, width, 3), dtype=np.float32)
    raw = np.frombuffer(data, dtype=np.uint8)

    # The native decoder takes the all-RLE scanline section in one call; on
    # any scanline header it does not take it returns < 0 and the Python
    # decoder below starts again from the same `pos`.
    if pos + 4 <= len(raw) and raw[pos] == 2 and raw[pos + 1] == 2 \
            and (raw[pos + 2] & 0x80) == 0:
        lib = _load_rle_native()
        if lib is not None:
            seg = np.ascontiguousarray(raw[pos:])
            out = np.empty((height * width, 4), dtype=np.uint8)
            consumed = lib.decode_hdr_rle(
                seg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_longlong(seg.size), width, height,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if consumed > 0:
                return decode_rgbe(out).reshape(height, width, 3)

    for y in range(height):
        if pos + 4 > len(raw):
            raise EnvmapLoadError("Unexpected end of HDR file.")
        header = raw[pos:pos + 4]
        is_rle = header[0] == 2 and header[1] == 2 \
            and (header[2] & 0x80) == 0
        scan_w = (int(header[2]) << 8) | int(header[3])
        if not is_rle or scan_w != width or width < 8 or width > 0x7FFF:
            # Flat (non-RLE) data: the 4 header bytes are the first pixel.
            total = width * height
            flat = np.empty((total, 4), dtype=np.uint8)
            flat[0] = header
            need = (total - 1) * 4
            chunk = raw[pos + 4:pos + 4 + need]
            if chunk.size < need:
                raise EnvmapLoadError(
                    "Unexpected end of HDR file (flat data).")
            flat[1:] = chunk.reshape(total - 1, 4)
            return decode_rgbe(flat).reshape(height, width, 3)
        pos += 4

        scan = np.zeros((4, width), dtype=np.uint8)
        for channel in range(4):
            x = 0
            while x < width:
                if pos >= len(raw):
                    raise EnvmapLoadError(
                        "Unexpected end of HDR file (RLE count).")
                count = int(raw[pos])
                pos += 1
                if count > 128:
                    run = count - 128
                    if pos >= len(raw):
                        raise EnvmapLoadError(
                            "Unexpected end of HDR file (RLE value).")
                    scan[channel, x:x + run] = raw[pos]
                    pos += 1
                    x += run
                else:
                    run = count
                    if run == 0 or x + run > width:
                        raise EnvmapLoadError("Invalid HDR RLE run.")
                    if pos + run > len(raw):
                        raise EnvmapLoadError(
                            "Unexpected end of HDR file (RLE data).")
                    scan[channel, x:x + run] = raw[pos:pos + run]
                    pos += run
                    x += run
        pixels[y] = decode_rgbe(scan.T.reshape(width, 4))

    return pixels


def _load_exr(path: str) -> np.ndarray:
    from .exr import read_exr
    return read_exr(path)[..., :3]


def _load_ldr(path: str) -> np.ndarray:
    """PNG or JPEG -> float32 [H, W, 3]: uint8 / 255, uint16 / 65535, grey
    replicated."""
    from ..metrics.image_io import decode_png
    from ..metrics.jpeg import decode_jpeg
    with open(path, "rb") as f:
        raw = f.read()
    if os.path.splitext(path)[1].lower() == ".png":
        img = decode_png(raw, rgb=False)
    else:
        img = decode_jpeg(raw)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    return img[..., :3]


class EnvironmentMap:
    """Host environment: pixels [H, W, 3] f32 (None until loaded), rotation
    in degrees around Y, strength."""

    def __init__(self, rotation: float = 0.0, strength: float = 1.0):
        self.pixels: np.ndarray | None = None
        self.rotation = float(rotation)
        self.strength = float(strength)

    @property
    def is_valid(self) -> bool:
        return self.pixels is not None and self.pixels.size > 0

    @property
    def width(self) -> int:
        return 0 if self.pixels is None else self.pixels.shape[1]

    @property
    def height(self) -> int:
        return 0 if self.pixels is None else self.pixels.shape[0]

    def load_from_file(self, path: str) -> None:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".exr":
            self.pixels = _load_exr(path)
        elif ext in (".png", ".jpg", ".jpeg"):
            self.pixels = _load_ldr(path)
        else:
            self.pixels = load_hdr(path)

    def to_tensors(self, device="cuda") -> "EnvironmentTensors":
        return EnvironmentTensors.from_numpy(
            self.pixels if self.is_valid else None, rotation=self.rotation,
            strength=self.strength, device=device)


@dataclass
class EnvironmentTensors:
    """pixels [3, H*W] f32 (zeros when invalid), rotation in degrees around
    Y, strength, static width/height/validity."""
    pixels: torch.Tensor
    rotation: float = 0.0
    strength: float = 1.0
    width: int = 1
    height: int = 1
    is_valid: bool = False

    @staticmethod
    def from_numpy(pixels: np.ndarray | None = None, rotation: float = 0.0,
                   strength: float = 1.0, device="cuda"):
        if pixels is None or pixels.size == 0:
            return EnvironmentTensors(
                pixels=torch.zeros((3, 1), dtype=torch.float32,
                                   device=device),
                rotation=float(rotation), strength=float(strength))
        h, w = pixels.shape[:2]
        pix = torch.as_tensor(
            np.ascontiguousarray(pixels.reshape(-1, 3).T, np.float32),
            device=device)
        return EnvironmentTensors(pixels=pix, rotation=float(rotation),
                                  strength=float(strength), width=w,
                                  height=h, is_valid=True)
