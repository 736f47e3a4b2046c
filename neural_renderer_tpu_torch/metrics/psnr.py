"""PSNR over 8-bit RGB images. Copy of `neural_renderer_tpu/metrics/psnr.py`."""

from __future__ import annotations

import numpy as np


def compute_psnr(ref: np.ndarray, test: np.ndarray) -> float:
    """ref/test: uint8 arrays [..., 3]. Returns dB, capped at 100 for
    identical images (mse < 1e-10)."""
    ref = np.asarray(ref)
    test = np.asarray(test)
    if ref.shape != test.shape:
        raise ValueError(f"image shapes differ: {ref.shape} vs {test.shape}")
    diff = ref.astype(np.float64) - test.astype(np.float64)
    mse = float(np.mean(np.sum(diff * diff, axis=-1) / 3.0))
    if mse < 1e-10:
        return 100.0
    return float(10.0 * np.log10((255.0 * 255.0) / mse))
