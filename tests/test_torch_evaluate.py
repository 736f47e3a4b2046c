"""The port's Renderer, metrics and `evaluate` app on the CPU.

Goldens: the three recorded renders of tests/golden/ through the port's
Renderer (scene loading, BVH build, clustered trace twin, hit data,
shading), to tests/test_golden.py's tolerance off the recording platform
(largest u8 difference 2, under 5% of pixels differ); no JAX run is needed.
Metrics: PSNR is float64 arithmetic on both sides and must be equal; FLIP
sums convolutions in another order, held to 1e-4. PNG: bytes written by
the port read back identical, by the port and by imageio.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from neural_renderer_tpu import metrics as jmetrics

from neural_renderer_tpu_torch import metrics
from neural_renderer_tpu_torch.cli import evaluate
from neural_renderer_tpu_torch.config import (camera_basis_from_state,
                                              load_config,
                                              matrix_to_camera_state)
from neural_renderer_tpu_torch.metrics import image_io
from neural_renderer_tpu_torch.render.renderer import (RenderBasis, Renderer,
                                                       npz_for_checkpoint)
from neural_renderer_tpu_torch.scene.scene import Scene

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


def _renderer(scene_dir, config_name, width=96, height=54, bounces=2):
    cfg = load_config(os.path.join(ROOT, "configs", scene_dir, config_name))
    scene = Scene.from_config(cfg)
    renderer = Renderer(scene, cfg.neural_network, device="cpu")
    renderer.resize(width, height)
    renderer.set_bounce_count(bounces)
    renderer.set_use_neural_query(False)
    pos, yaw, pitch = matrix_to_camera_state(cfg.camera.matrix)
    fwd, right, up, fov = camera_basis_from_state(yaw, pitch, cfg.camera.yfov)
    renderer.set_camera_basis(RenderBasis(fwd, right, up, fov))
    return cfg, renderer, pos


def _render_golden(name):
    if name == "knot_lambert_96x54":
        _, renderer, pos = _renderer("knot", "knot.json")
        renderer.set_lambert_view(True)
    else:
        _, renderer, pos = _renderer("sphere", "sphere.json")
        renderer.set_lambert_view(name == "gt_lambert_96x54")
    return renderer.render(pos)


@pytest.mark.parametrize("name", ["gt_lambert_96x54", "gt_path_96x54_spp1_b2",
                                  "knot_lambert_96x54"])
def test_recorded_goldens(name):
    golden = image_io.load_image(os.path.join(GOLDEN_DIR, f"{name}.png"))
    img = _render_golden(name)
    assert img.shape == golden.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(int) - golden.astype(int))
    assert diff.max() <= 2
    assert (diff.sum(axis=-1) > 0).mean() < 0.05


def _two_images(seed=4, h=40, w=56):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(xx / 7.0), 128 + 90 * np.cos(yy / 5.0),
                     (xx + yy) * 2.0], axis=-1)
    a = np.clip(base + r.normal(0, 6, base.shape), 0, 255).astype(np.uint8)
    b = np.clip(base + r.normal(0, 14, base.shape), 0, 255).astype(np.uint8)
    b[10:20, 10:30] = 255 - b[10:20, 10:30]
    return a, b


def test_psnr_and_flip_match_jax(tmp_path):
    a, b = _two_images()
    assert metrics.compute_psnr(a, b) == jmetrics.compute_psnr(a, b)
    assert metrics.compute_psnr(a, a) == 100.0
    out = str(tmp_path / "flip.png")
    mean, worst = metrics.compute_flip(a, b, output_path=out, device="cpu")
    jmean, jworst = jmetrics.compute_flip(a, b, device="cpu")
    print(f"FLIP mean {mean} vs {jmean}, max {worst} vs {jworst}")
    assert abs(mean - jmean) <= 1e-4 and abs(worst - jworst) <= 1e-4
    fmap = metrics.compute_flip_map(a / 255.0, b / 255.0,
                                    device="cpu").numpy()
    jmap = np.asarray(jmetrics.compute_flip_map(a / 255.0, b / 255.0))
    assert np.abs(fmap - jmap).max() <= 1e-4
    # The visualization is the Magma colormap of the error map.
    from matplotlib import cm
    want = (cm.magma(np.clip(fmap, 0.0, 1.0))[..., :3] * 255.0).astype(
        np.uint8)
    np.testing.assert_array_equal(image_io.load_image(out), want)


def test_png_round_trip(tmp_path):
    import imageio.v3 as iio
    a, _ = _two_images(seed=8, h=33, w=47)
    path = str(tmp_path / "a.png")
    assert image_io.save_png(path, a)
    np.testing.assert_array_equal(image_io.load_image(path), a)
    np.testing.assert_array_equal(np.asarray(iio.imread(path)), a)
    # The reader takes what other writers emit: adaptive filters, RGBA, grey.
    other = str(tmp_path / "b.png")
    iio.imwrite(other, a)
    np.testing.assert_array_equal(image_io.load_image(other), a)
    rgba = np.concatenate([a, np.full(a.shape[:2] + (1,), 200, np.uint8)],
                          axis=-1)
    iio.imwrite(other, rgba)
    np.testing.assert_array_equal(image_io.load_image(other), a)
    iio.imwrite(other, a[..., 0])
    np.testing.assert_array_equal(image_io.load_image(other)[..., 2],
                                  a[..., 0])
    with pytest.raises(ValueError):
        image_io.decode_png(b"not a png at all")


def test_checkpoint_npz_path():
    assert npz_for_checkpoint("/x/lane16_ckpt/step_24000") == \
        "/x/lane16_step24000.npz"
    assert npz_for_checkpoint("/x/lane_ckpt/step_48000/") == \
        "/x/lane_step48000.npz"
    assert npz_for_checkpoint("/x/w.npz") == "/x/w.npz"
    with pytest.raises(ValueError):
        npz_for_checkpoint("/x/weights.bin")
    for scene, cfg_name in (("sphere", "sphere_lane.json"),
                            ("knot", "knot_lane.json"),
                            ("studio", "studio_lane.json")):
        cfg = load_config(os.path.join(ROOT, "configs", scene, cfg_name))
        assert os.path.exists(npz_for_checkpoint(cfg.checkpoint_path))


@pytest.mark.parametrize("neural", [False, True])
def test_render_accumulate_equals_renders(neural):
    """render_accumulate(n) equals n calls of render: same image, same
    accumulator."""
    cfg, renderer, pos = _renderer("sphere", "sphere_lane.json", 40, 24, 3)
    assert renderer.load_weights_from_file(cfg.checkpoint_path)
    renderer.set_use_neural_query(neural)
    img = None
    for _ in range(3):
        img = renderer.render(pos)
    assert renderer.accum_sample_count == 3
    accum = renderer._accum.clone()
    got = renderer.render_accumulate(pos, 3, batch_spp=1)
    np.testing.assert_array_equal(got, img)
    assert torch.equal(renderer._accum, accum)
    assert (img != img[0, 0]).any()
    with pytest.raises(ValueError):
        renderer.render_accumulate(pos, 3, batch_spp=2)


def test_evaluate_main_cpu(tmp_path, capsys):
    out = str(tmp_path / "cmp")
    rc = evaluate.main([
        os.path.join(ROOT, "configs", "sphere", "sphere_lane.json"),
        "--width", "48", "--height", "27", "--total-samples", "2",
        "--batch-spp", "1", "--device", "cpu", "--output", out])
    text = capsys.readouterr().out
    assert rc == 0
    import re
    psnr = re.search(r"PSNR: ([0-9.]+) dB", text)
    flip = re.search(r"FLIP: ([0-9.]+) \(mean\)", text)
    assert psnr and flip and "FLIP max error" in text
    assert float(psnr.group(1)) > 30.0 and float(flip.group(1)) < 0.05
    gt = image_io.load_image(os.path.join(out, "ground_truth.png"))
    nn = image_io.load_image(os.path.join(out, "neural.png"))
    fl = image_io.load_image(os.path.join(out, "flip_error.png"))
    assert gt.shape == nn.shape == fl.shape == (27, 48, 3)
    assert metrics.compute_psnr(gt, nn) == pytest.approx(
        float(psnr.group(1)), abs=0.006)


def test_evaluate_refuses_missing_device_and_unported_inputs(tmp_path,
                                                             capsys):
    """Without a card `evaluate` ends with rc 1 unless given --device cpu.
    Every format the JAX package reads loads: the studio scene (EXR sky,
    glTF torus), a DWAA sky. What the port still refuses is refused by
    name: a mesh file that does not parse, and an arithmetic-coded JPEG
    sky, which `evaluate` refuses with rc 1 rather than render the
    procedural sky in its place."""
    cfg_path = os.path.join(ROOT, "configs", "sphere", "sphere_lane.json")
    if not torch.cuda.is_available():
        assert evaluate.main([cfg_path, "--output", str(tmp_path)]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    studio = load_config(os.path.join(ROOT, "configs", "studio",
                                      "studio_lane.json"))
    scene = Scene.from_config(studio)
    assert scene.environment.is_valid and scene.environment_error is None
    assert scene.original_mesh.num_triangles == 2304
    from neural_renderer_tpu_torch.scene.mesh_loader import (MeshLoadError,
                                                             load_mesh_auto)
    (tmp_path / "m.ply").write_bytes(b"ply\nformat ascii 1.0\nend_header\n")
    with pytest.raises(MeshLoadError, match="PLY missing vertex or face"):
        load_mesh_auto(str(tmp_path / "m.ply"))
    cfg = json.load(open(os.path.join(ROOT, "configs", "studio",
                                      "studio_lane.json")))
    base = os.path.join(ROOT, "configs", "studio")
    for scene_key in ("original_mesh", "inner_shell", "outer_shell",
                      "additional_mesh"):
        cfg["scene"][scene_key]["path"] = os.path.join(
            base, cfg["scene"][scene_key]["path"])
    cfg["checkpoint_path"] = os.path.join(base, cfg["checkpoint_path"])
    cfg["environment"]["hdri_path"] = os.path.join(
        ROOT, "tests", "golden", "dwaa_reference.exr")
    dwa_cfg = tmp_path / "dwa.json"
    dwa_cfg.write_text(json.dumps(cfg))
    dwa_scene = Scene.from_config(load_config(str(dwa_cfg)))
    assert dwa_scene.environment_error is None
    assert dwa_scene.environment.pixels.shape == (48, 64, 3)
    jpg = tmp_path / "sky.jpg"
    # An SOF9 (arithmetic-coded) frame header after SOI.
    jpg.write_bytes(b"\xff\xd8\xff\xc9\x00\x0b\x08\x00\x08\x00\x08"
                    b"\x01\x01\x11\x00\xff\xd9")
    cfg["environment"]["hdri_path"] = str(jpg)
    sky_cfg = tmp_path / "arith.json"
    sky_cfg.write_text(json.dumps(cfg))
    capsys.readouterr()
    assert evaluate.main([str(sky_cfg), "--width", "8", "--height", "8",
                          "--device", "cpu", "--output",
                          str(tmp_path / "out")]) == 1
    assert "arithmetic-coded" in capsys.readouterr().err


def test_evaluate_studio_cpu(tmp_path, capsys):
    """`evaluate` on the studio scene at 64x36 x 2 samples with the hybrid
    additional mesh: rc 0, the three PNGs at that size, PSNR and FLIP
    printed, the PSNR that of the written images. The neural pass shows the
    additional mesh (a ground plane and a sphere) that the ground-truth
    pass never traces, so it scores low (about 13 dB); the gate without it
    is tests/test_torch_studio_gate.py."""
    out = tmp_path / "studio"
    rc = evaluate.main([os.path.join(ROOT, "configs", "studio",
                                     "studio_lane.json"),
                        "--width", "64", "--height", "36",
                        "--total-samples", "2", "--batch-spp", "2",
                        "--device", "cpu", "--output", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    images = [metrics.load_image(str(out / f"{n}.png")) for n in (
        "ground_truth", "neural", "flip_error")]
    assert all(im.shape == (36, 64, 3) for im in images)
    psnr = re.search(r"PSNR: ([0-9.]+) dB", text)
    flip = re.search(r"FLIP: ([0-9.]+) \(mean\)", text)
    assert psnr and flip, text
    assert float(psnr.group(1)) == round(
        metrics.compute_psnr(images[0], images[1]), 2)
    assert 0.0 < float(flip.group(1)) < 1.0
    assert images[0].std() > 5.0 and images[1].std() > 5.0


def test_evaluate_refuses_uneven_samples_and_missing_shell(tmp_path, capsys):
    """A sample count the batches do not divide, and a shell file that does
    not load, end the run with rc 1 before anything is rendered: neither a
    last partial batch nor ground truth against ground truth is reported."""
    import json
    cfg_path = os.path.join(ROOT, "configs", "sphere", "sphere_lane.json")
    size = ["--width", "16", "--height", "9", "--device", "cpu", "--output",
            str(tmp_path / "out")]
    assert evaluate.main([cfg_path, "--total-samples", "3", "--batch-spp",
                          "2"] + size) == 1
    assert "multiple of --batch-spp" in capsys.readouterr().err
    with open(cfg_path) as f:
        j = json.load(f)
    sphere_dir = os.path.dirname(cfg_path)
    for key in ("original_mesh", "inner_shell", "outer_shell"):
        j["scene"][key]["path"] = os.path.join(sphere_dir,
                                               j["scene"][key]["path"])
    j["checkpoint_path"] = os.path.join(sphere_dir, j["checkpoint_path"])
    j["scene"]["outer_shell"]["path"] = str(tmp_path / "no_such_outer.obj")
    broken = str(tmp_path / "broken.json")
    with open(broken, "w") as f:
        json.dump(j, f)
    assert evaluate.main([broken, "--total-samples", "1", "--batch-spp", "1"]
                         + size) == 1
    assert "could not load: outer shell" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "out" / "ground_truth.png"))
    # The Renderer itself refuses a neural frame without an outer shell.
    cfg = load_config(broken)
    scene = Scene.from_config(cfg)
    assert scene.failed_meshes == ["outer shell"]
    renderer = Renderer(scene, cfg.neural_network, device="cpu")
    renderer.resize(16, 9)
    renderer.set_use_neural_query(True)
    with pytest.raises(RuntimeError, match="outer shell"):
        renderer.render([0.0, 0.0, 3.0])
