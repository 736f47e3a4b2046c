#!/usr/bin/env python
"""Write the JPEG fixtures and their Pillow decodes.

The port decodes JPEG itself (neural_renderer_tpu_torch/metrics/jpeg.py),
while the JAX package reads it through imageio, that is Pillow with
libjpeg-turbo. The machine with the GPU has neither, so these files carry
Pillow's answers with them:

  tests/golden/studio_sky_baseline.jpg     configs/studio/sky.exr clipped to
  tests/golden/studio_sky_progressive.jpg  [0, 1] and sRGB-encoded, 4:2:0,
                                           quality 90, sequential and
                                           progressive
  tests/golden/grey_restart.jpg            a seeded 37x23 grey image with a
                                           restart marker every 2 blocks
  tests/golden/<name>_decode.npy           each file's decode by Pillow

tests/test_torch_jpeg.py and chip_smoke.py (phase 23) hold the port's
decoder to the .npy files byte for byte. Needs Pillow (through imageio) and
numpy; reads sky.exr with the port's own EXR reader.

Run from the repo root: python scripts/make_jpeg_fixture.py
"""

import io
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def srgb_u8(linear: np.ndarray) -> np.ndarray:
    """Linear [0, 1] -> sRGB-encoded uint8."""
    x = np.clip(linear.astype(np.float64), 0.0, 1.0)
    s = np.where(x <= 0.0031308, 12.92 * x,
                 1.055 * np.power(x, 1.0 / 2.4) - 0.055)
    return np.round(s * 255.0).astype(np.uint8)


def main() -> int:
    import imageio.v3 as iio
    from PIL import Image
    sys.path.insert(0, ROOT)
    from neural_renderer_tpu_torch.scene.exr import read_exr

    sky = srgb_u8(read_exr(os.path.join(ROOT, "configs", "studio",
                                        "sky.exr")))
    grey = np.random.default_rng(14).integers(0, 256, (23, 37),
                                              dtype=np.uint8)
    files = {
        "studio_sky_baseline": (sky, dict(quality=90, subsampling=2)),
        "studio_sky_progressive": (sky, dict(quality=90, subsampling=2,
                                             progressive=True)),
        "grey_restart": (grey, dict(quality=75, restart_marker_blocks=2)),
    }
    for name, (pixels, options) in files.items():
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, "JPEG", **options)
        path = os.path.join(GOLDEN, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        decoded = np.asarray(iio.imread(path))
        np.save(os.path.join(GOLDEN, f"{name}_decode.npy"), decoded)
        print(f"{path}: {len(buf.getvalue())} bytes, decode "
              f"{decoded.shape} {decoded.dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
