"""The port's viewer app on the CPU: the camera maths and input controller
against the JAX package's, MotionScaler, the headless and train-while-render
modes, the key bindings (`apply_key`) and what the viewer refuses.

The camera matrix and the controller are float64 / float32 numpy on both
sides and must be equal. Train-while-render starts from seeded weights,
as tests/test_cli.py::test_viewer_train_while_render does: three finite
losses, the last below the first, the accumulation restarting every frame,
the checkpoint written and taken by `cli/train.py --resume`.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from neural_renderer_tpu import config as jconfig
from neural_renderer_tpu.cli import input_controller as jic

from torch_scenes import tiny_config

from neural_renderer_tpu_torch import config
from neural_renderer_tpu_torch.cli import train as train_cli
from neural_renderer_tpu_torch.cli import viewer
from neural_renderer_tpu_torch.cli.input_controller import (
    MAX_PITCH, CameraState, InputController)
from neural_renderer_tpu_torch.metrics import load_image

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_camera_state_to_matrix_matches_jax():
    r = np.random.default_rng(5)
    for pos, yaw, pitch in [((0, 0, 3.0), -90.0, 0.0), ((1, 2, 3.0), 0, 90),
                            ((0, 0, 0.0), 45.0, -90.0)] + [
            (r.normal(size=3) * 4, r.uniform(-360, 360), r.uniform(-89, 89))
            for _ in range(20)]:
        got = config.camera_state_to_matrix(np.asarray(pos), yaw, pitch)
        want = jconfig.camera_state_to_matrix(np.asarray(pos), yaw, pitch)
        assert got.dtype == np.float32 and got.shape == (16,)
        np.testing.assert_array_equal(got, want)
        if abs(pitch) < 89:
            p, y, t = config.matrix_to_camera_state(got)
            np.testing.assert_allclose(p, pos, atol=1e-4)
            assert np.cos(np.radians(y - yaw)) == pytest.approx(1, abs=1e-6)
            assert t == pytest.approx(pitch, abs=1e-3)


def test_controller_matches_jax():
    """The same seeded key and mouse stream through both controllers."""
    r = np.random.default_rng(11)
    start = dict(position=np.array([0.5, -0.2, 3.0], np.float32), yaw=-80.0,
                 pitch=10.0)
    a = InputController(CameraState(**start), move_speed=1.7)
    b = jic.InputController(jic.CameraState(**start), move_speed=1.7)
    names = ["w", "s", "a", "d", "space", "ctrl", "q", "e", "shift"]
    for _ in range(60):
        if r.uniform() < 0.5:
            keys = {n for n in names if r.uniform() < 0.3}
            dt = float(r.uniform(0.0, 0.2))
            a.apply_keys(keys, dt)
            b.apply_keys(keys, dt)
        else:
            dx, dy = (float(v) for v in r.normal(scale=60, size=2))
            a.apply_mouse_delta(dx, dy)
            b.apply_mouse_delta(dx, dy)
        np.testing.assert_array_equal(a.camera.position, b.camera.position)
        assert (a.camera.yaw, a.camera.pitch) == (b.camera.yaw,
                                                  b.camera.pitch)
        for f in ("forward", "right", "up"):
            np.testing.assert_array_equal(getattr(a.basis, f),
                                          getattr(b.basis, f))


def test_controller_moves_in_basis():
    c = InputController(CameraState(position=np.zeros(3, np.float32),
                                    yaw=-90.0, pitch=0.0))
    np.testing.assert_allclose(c.basis.forward, [0, 0, -1], atol=1e-6)
    c.apply_keys({"w"}, dt=2.0)
    np.testing.assert_allclose(c.camera.position, [0, 0, -2], atol=1e-5)
    c.apply_keys({"d", "shift"}, dt=1.0)  # shift doubles the speed
    np.testing.assert_allclose(c.camera.position, [2, 0, -2], atol=1e-5)
    c.apply_keys({"space"}, dt=0.5)
    np.testing.assert_allclose(c.camera.position, [2, 0.5, -2], atol=1e-5)


def test_controller_pitch_clamp_and_sensitivity():
    c = InputController()
    c.apply_mouse_delta(10.0, 0.0)
    assert c.camera.yaw == pytest.approx(-90.0 + 1.0)  # 0.1 deg/px
    c.apply_mouse_delta(0.0, 10000.0)  # a wild jump is ignored
    assert c.camera.pitch == pytest.approx(0.0)
    for _ in range(20):
        c.apply_mouse_delta(0.0, 99.0)
    assert c.camera.pitch == MAX_PITCH


def test_motion_scaler():
    s = viewer.MotionScaler(1920, 1080, drop=4, hold=0.25)
    assert s.update(False, 0.0) == (1920, 1080)
    assert s.update(True, 1.0) == (480, 270)
    assert s.update(False, 1.1) == (480, 270)    # still within hold
    assert s.update(False, 1.3) == (1920, 1080)  # restored
    img = np.arange(270 * 480 * 3, dtype=np.uint32).reshape(270, 480, 3)
    up = s.upscale(img.astype(np.uint8))
    assert up.shape == (1080, 1920, 3)
    np.testing.assert_array_equal(up[::4, ::4], img.astype(np.uint8))
    full = np.zeros((1080, 1920, 3), np.uint8)
    assert s.upscale(full) is full
    assert viewer.MotionScaler(637, 353, drop=1).update(True, 0.0) == \
        (637, 353)
    assert viewer.MotionScaler(637, 353, drop=4).preview == (158, 88)


def _frames(out):
    return [(int(m.group(1)), m.group(2)) for m in re.finditer(
        r"frame \d+: (\d+) spp accumulated, [0-9.]+ Mrays/s, [0-9.]+ fps"
        r"(, loss [0-9.]+)?", out)]


def test_viewer_headless(tmp_path, capsys):
    cfg = tiny_config(tmp_path)
    out_dir = str(tmp_path / "view")
    assert viewer.main([cfg, "--headless", "2", "--output", out_dir,
                        "--device", "cpu", "--save-sequence"]) == 0
    out = capsys.readouterr().out
    assert "Loaded checkpoint" in out
    assert [n for n, _ in _frames(out)] == [1, 2]
    final = load_image(os.path.join(out_dir, "viewer_final.png"))
    assert final.shape == (16, 24, 3) and final.std() > 1.0
    np.testing.assert_array_equal(
        final, load_image(os.path.join(out_dir, "frame_0001.png")))


def test_viewer_train_while_render(tmp_path, capsys):
    """From seeded weights (no checkpoint): 4 steps of 512 segments before
    each of 3 frames; the exit checkpoint resumes in cli/train.py."""
    cfg = tiny_config(tmp_path, weights=False)
    ckpt_dir = str(tmp_path / "live_ckpt")
    assert viewer.main([cfg, "--headless", "3", "--output",
                        str(tmp_path / "view"), "--train-steps", "4",
                        "--train-batch", "512", "--train-ckpt-dir",
                        ckpt_dir, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss ([0-9.]+)", out)]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "train steps/s" in out and "warm start" not in out
    # Every frame renders new weights: the accumulation restarts.
    assert [n for n, _ in _frames(out)] == [1, 1, 1]
    weights = str(tmp_path / "live_step12.npz")
    assert f"checkpoint: {weights}" in out
    assert train_cli.main([cfg, "--steps", "13", "--batch-size", "256",
                           "--resume", weights, "--device", "cpu",
                           "--log-every", "1", "--ckpt-dir",
                           str(tmp_path / "resumed_ckpt")]) == 0
    out = capsys.readouterr().out
    assert "from step 12" in out and "step 13/13" in out


def test_viewer_warm_start_and_refusals(tmp_path, capsys):
    """With weights loaded the trainer fine-tunes them; an orbax directory
    as --train-resume, --dp 0 and (without a card) the default device end
    with rc 1 and a message; so does the interactive mode without a GUI
    backend or without matplotlib."""
    cfg = tiny_config(tmp_path)
    assert viewer.main([cfg, "--headless", "1", "--train-steps", "1",
                        "--train-batch", "256", "--device", "cpu",
                        "--output", str(tmp_path / "v")]) == 0
    assert "(warm start)" in capsys.readouterr().out
    orbax = os.path.join(ROOT, "configs", "sphere", "lane16_ckpt",
                         "step_24000")
    assert viewer.main([cfg, "--headless", "1", "--train-steps", "1",
                        "--train-resume", orbax, "--device", "cpu",
                        "--output", str(tmp_path / "v")]) == 1
    assert "orbax" in capsys.readouterr().err
    assert viewer.main([cfg, "--headless", "1", "--dp", "0"]) == 1
    assert "multi-GPU" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert viewer.main([cfg, "--headless", "1"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    args = [cfg, "--device", "cpu", "--output", str(tmp_path / "v")]
    import matplotlib
    matplotlib.use("agg")
    assert viewer.main(args) == 1
    assert "no GUI backend" in capsys.readouterr().err
    saved = sys.modules.get("matplotlib")
    sys.modules["matplotlib"] = None
    try:
        assert viewer.main(args) == 1
    finally:
        sys.modules["matplotlib"] = saved
    assert "matplotlib unavailable" in capsys.readouterr().err


def test_sphere_fallback(tmp_path, capsys):
    """A config whose original mesh does not load: the viewer's scene holds
    the JAX viewer's 32x64 UV sphere and names the failure; `evaluate`
    still refuses it."""
    from neural_renderer_tpu.scene.scene import Scene as JScene
    from neural_renderer_tpu_torch.cli import evaluate
    from neural_renderer_tpu_torch.scene.scene import Scene
    cfg = tiny_config(tmp_path, original="missing.obj")
    scene = Scene.from_config(config.load_config(cfg), sphere_fallback=True)
    want = JScene.from_config(jconfig.load_config(cfg), sphere_fallback=True)
    assert scene.original_mesh.num_triangles == \
        want.original_mesh.num_triangles == 4096
    np.testing.assert_array_equal(scene.original_mesh.vertices,
                                  want.original_mesh.vertices)
    assert scene.failed_meshes == ["original"]
    assert Scene.from_config(config.load_config(cfg)).original_mesh \
        .num_triangles == 0
    assert viewer.main([cfg, "--headless", "1", "--device", "cpu",
                        "--output", str(tmp_path / "v")]) == 0
    assert "Loaded original mesh: 4096 triangles" in capsys.readouterr().out
    assert evaluate.main([cfg, "--width", "8", "--height", "8", "--device",
                          "cpu", "--output", str(tmp_path / "e")]) == 1
    assert "could not load: original" in capsys.readouterr().err


def test_apply_key_toggles(tmp_path, capsys):
    """apply_key drives the renderer as the window's key events do; each
    toggle shows in the next frame."""
    cfg = tiny_config(tmp_path, bounces=2)
    ns = type("Args", (), dict(config=cfg, device="cpu", width=0, height=0,
                               spp=1, ckpt=""))
    _, rend, ctl, basis = viewer.build_renderer(ns)
    rend.set_camera_basis(basis())
    pos = ctl.camera.position

    def key(k, **kw):
        return viewer.apply_key(rend, ctl, k, out_dir=str(tmp_path), **kw)

    base = rend.render(pos)
    assert rend.use_neural_query
    assert not key("x") and rend.denoise
    den = rend.render(pos)
    assert (den != base).any() and rend._guides is not None
    key("x")
    assert not rend.denoise
    key("l")
    lam = rend.render(pos)
    assert rend.lambert_view and rend.accum_sample_count == 0
    assert (lam != base).any()
    key("l")
    key("b")
    assert rend.bounce_count == 1
    key("shift+b")
    key("shift+b")
    assert rend.bounce_count == 3
    key("shift+p")
    assert rend.samples_per_pixel == 2
    rend.render(pos)
    key("p")
    key("p")
    assert rend.samples_per_pixel == 1
    key("n")
    assert not rend.use_neural_query
    gt = rend.render(pos)
    for index, name in ((1, "inner_shell"), (2, "outer_shell"),
                        (0, "original_mesh")):
        key("m")
        assert rend.classic_mesh_index == index
        assert rend._classic_name() == name
    key("m")
    inner = rend.render(pos)
    assert (inner != gt).any()
    key("m")
    key("m")
    key("g")
    assert rend.use_direct_env_color
    key("v")
    assert rend.env_strength == pytest.approx(0.8)
    key("shift+r")
    assert rend.envmap_rotation == 15.0
    fov = ctl.camera.fov_y
    key("f")
    assert ctl.camera.fov_y == pytest.approx(fov - 0.05)
    yaw = ctl.camera.yaw
    key("right")
    assert ctl.camera.yaw == pytest.approx(yaw + 2.0)
    pressed = set()
    key("w", pressed=pressed)
    key("shift", pressed=pressed)
    assert pressed == {"w", "shift"}
    capsys.readouterr()
    key("c")
    blob = json.loads(capsys.readouterr().out)
    np.testing.assert_array_equal(
        np.asarray(blob["matrix"], np.float32),
        config.camera_state_to_matrix(ctl.camera.position, ctl.camera.yaw,
                                      ctl.camera.pitch))
    key("shift+c")
    assert json.load(open(tmp_path / "camera_export.json")) == blob
    rend.render(pos)
    key("o")
    np.testing.assert_array_equal(load_image(str(tmp_path /
                                                 "viewer_capture.png")),
                                  rend.device_pixels())
    capsys.readouterr()
    key("i")
    stats = json.loads(capsys.readouterr().out)
    assert stats["original_mesh"]["triangles"] == 256
    key("t")
    assert "frame total" in capsys.readouterr().out
    trainer = type("T", (), {"enabled": True})()
    key("u", trainer=trainer)
    assert not trainer.enabled
    key("h")
    assert "apply_key" in capsys.readouterr().out
    assert key("escape") is True


def test_renderer_without_weights_is_refused(tmp_path, capsys):
    """The port's Renderer renders no neural frame without weights (the JAX
    one renders zero weights); the viewer says so and returns 1."""
    cfg = tiny_config(tmp_path, weights=False)
    assert viewer.main([cfg, "--headless", "1", "--device", "cpu",
                        "--output", str(tmp_path / "v")]) == 1
    assert "without weights" in capsys.readouterr().err
