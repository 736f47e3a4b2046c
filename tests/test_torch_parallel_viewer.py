"""The viewer's `--dp` entry point on the CPU: `viewer.main` spawns its ranks
over gloo (`--device cpu`), as a user runs it.

Each test runs the CLI with `--dp 2` and with `--dp 1` on the tiny scene of
tests/torch_scenes.py and holds the two against each other:
  * headless frames (`--save-sequence`): byte for byte;
  * `--bench-motion`: the rest frame (render_accumulate in stripes, the
    motion loop's condition broadcast from rank 0), byte for byte;
  * train-while-render (`--train-steps`): the ranks run the meshed step
    (each batch's rows split, one network), so the printed losses agree to
    1e-3 relative, the exit checkpoint's moments to 1e-3 of their largest
    value (K6's tolerance in the dp/tp tests) and its weights to 1e-6 of
    their largest; the frames rendered from those weights to one u8 step.
"""

import re

import numpy as np
import torch

from torch_scenes import tiny_config

from neural_renderer_tpu_torch.cli import viewer
from neural_renderer_tpu_torch.metrics import load_image

torch.set_num_threads(1)


def _run(cfg, out_dir, dp, capfd, *flags):
    assert viewer.main([cfg, "--device", "cpu", "--output", str(out_dir),
                        "--dp", str(dp), *flags]) == 0
    return capfd.readouterr()


def _png(path):
    return path.read_bytes()


def test_viewer_dp_headless_cpu(tmp_path, capfd):
    """viewer --dp 2 --headless 2 --save-sequence writes the frames of
    --dp 1, byte for byte, and names its backend on stderr."""
    cfg = tiny_config(tmp_path)
    flags = ("--headless", "2", "--save-sequence")
    _run(cfg, tmp_path / "one", 1, capfd, *flags)
    out, err = _run(cfg, tmp_path / "two", 2, capfd, *flags)
    assert "2 ranks over gloo" in err and "falls back" not in err
    assert out.count("frame 1: 2 spp accumulated") == 1
    for name in ("frame_0000.png", "frame_0001.png", "viewer_final.png"):
        assert _png(tmp_path / "two" / name) == _png(tmp_path / "one" / name)
    assert load_image(str(tmp_path / "two" / "viewer_final.png")).std() > 5


def test_viewer_dp_bench_motion_cpu(tmp_path, capfd):
    """viewer --dp 2 --bench-motion: every rank leaves the motion loop
    together and the rest frame equals --dp 1's."""
    cfg = tiny_config(tmp_path)
    flags = ("--bench-motion", "0.3")
    _run(cfg, tmp_path / "one", 1, capfd, *flags)
    out, _ = _run(cfg, tmp_path / "two", 2, capfd, *flags)
    assert re.search(r"motion: \d+ frames", out)
    assert "rest: 4 spp at 24x16" in out
    name = "bench_motion_final.png"
    assert _png(tmp_path / "two" / name) == _png(tmp_path / "one" / name)


def test_viewer_dp_train_while_render_cpu(tmp_path, capfd):
    """Train-while-render under --dp 2 takes the meshed step: the losses,
    the exit checkpoint and the frames agree with one process's."""
    cfg = tiny_config(tmp_path)
    runs = {}
    for dp in (1, 2):
        out, _ = _run(cfg, tmp_path / f"view{dp}", dp, capfd,
                      "--headless", "2", "--train-steps", "2",
                      "--train-batch", "256", "--train-ckpt-dir",
                      str(tmp_path / f"live{dp}_ckpt"))
        weights = tmp_path / f"live{dp}_step4.npz"
        assert f"checkpoint: {weights}" in out
        with np.load(weights) as z, \
                np.load(str(weights)[:-4] + ".adam.npz") as m:
            runs[dp] = ([float(x) for x in re.findall(r"loss ([0-9.]+)",
                                                       out)],
                        {k: z[k] for k in z.files},
                        {k: m[k] for k in m.files})
    (l1, p1, m1), (l2, p2, m2) = runs[1], runs[2]
    assert len(l1) == len(l2) == 2 and l1[1] < l1[0]
    np.testing.assert_allclose(l2, l1, rtol=1e-3)
    assert int(m2["step"]) == int(m1["step"]) == 4
    for name, p in p1.items():
        ea = m1[f"exp_avg_{name}"]
        top = np.abs(ea).max()
        assert np.abs(m2[f"exp_avg_{name}"] - ea).max() <= 1e-3 * top, name
        assert np.abs(p2[name] - p).max() <= 1e-6 * np.abs(p).max(), name
    a, b = (load_image(str(tmp_path / f"view{dp}" / "viewer_final.png"))
            .astype(np.int32) for dp in (1, 2))
    assert np.abs(a - b).max() <= 1
