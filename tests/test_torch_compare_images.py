"""The port's `compare_images` CLI against the JAX package's, on the CPU.

`cli/compare_images.py` keeps the JAX CLI's usage, printed lines, return
codes and Y-flip detection (the flipped test image is used when flipping
raises the PSNR by more than 3 dB); FLIP runs on the card unless
`--device cpu` is given. With `--device cpu` the port's standard output
equals the JAX CLI's line for line (PSNR to two decimals, FLIP to four) on
a PNG pair, a PNG / JPEG pair and a vertically flipped pair, both write the
same FLIP map, and both return 1 for images of different sizes and for too
few arguments.
"""

import io
import os

import numpy as np
import pytest
import torch

from PIL import Image

from neural_renderer_tpu.cli import compare_images as jcli

from neural_renderer_tpu_torch.cli import compare_images as tcli
from neural_renderer_tpu_torch.metrics import image_io

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)


def _images(tmp_path):
    """A seeded smooth reference, a noisy copy as PNG and as JPEG, the
    noisy copy flipped upside down, and a smaller image."""
    rng = np.random.default_rng(21)
    y, x = np.mgrid[0:40, 0:56].astype(np.float64)
    ref = np.clip(np.stack([128 + 100 * np.sin(x / 6 + c) * np.cos(y / 9)
                            for c in range(3)], -1), 0, 255).astype(np.uint8)
    test = np.clip(ref.astype(int) + rng.integers(-12, 13, ref.shape), 0,
                   255).astype(np.uint8)
    paths = {k: str(tmp_path / f"{k}.png")
             for k in ("ref", "test", "flipped", "small")}
    image_io.save_png(paths["ref"], ref)
    image_io.save_png(paths["test"], test)
    image_io.save_png(paths["flipped"], test[::-1])
    image_io.save_png(paths["small"], ref[:20])
    buf = io.BytesIO()
    Image.fromarray(test).save(buf, "JPEG", quality=85)
    paths["jpeg"] = str(tmp_path / "test.jpg")
    open(paths["jpeg"], "wb").write(buf.getvalue())
    return paths


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("test_key", ["test", "jpeg", "flipped"])
def test_printed_lines_equal_jax(tmp_path, capsys, test_key):
    paths = _images(tmp_path)
    args = [paths["ref"], paths[test_key]]
    jflip, tflip = str(tmp_path / "jflip.png"), str(tmp_path / "tflip.png")
    rc_j, out_j, _ = _run(jcli.main, args + [jflip], capsys)
    rc_t, out_t, _ = _run(tcli.main, args + [tflip, "--device", "cpu"],
                          capsys)
    assert rc_j == rc_t == 0
    lines_j = out_j.replace(jflip, tflip).splitlines()
    # save_png announces the FLIP map on stdout in both packages.
    assert out_t.splitlines() == lines_j
    assert ("Detected Y-flipped" in out_t) == (test_key == "flipped")
    flip_j = image_io.load_image(jflip)
    flip_t = image_io.load_image(tflip)
    assert flip_t.shape == flip_j.shape == (40, 56, 3)
    # The two FLIP maps are float32 computations in two frameworks; their
    # Magma colours agree to one colormap step on all but a few pixels.
    assert (np.abs(flip_t.astype(int) - flip_j.astype(int)) > 8).mean() \
        < 0.01


def test_return_codes_equal_jax(tmp_path, capsys):
    paths = _images(tmp_path)
    for argv in ([paths["ref"], paths["small"]], [paths["ref"]], []):
        rc_j, out_j, err_j = _run(jcli.main, argv, capsys)
        rc_t, out_t, err_t = _run(tcli.main, argv + ["--device=cpu"],
                                  capsys)
        assert rc_j == rc_t == 1
        assert out_t == out_j
        assert err_t.splitlines()[:3] == err_j.splitlines()[:3]
    if not torch.cuda.is_available():
        rc, _, err = _run(tcli.main, [paths["ref"], paths["test"]], capsys)
        assert rc == 1 and "no CUDA device" in err
