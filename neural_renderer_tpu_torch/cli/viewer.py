"""viewer CLI: interactive or headless progressive renderer.

Port of `neural_renderer_tpu/cli/viewer.py`: the render loop, progressive
accumulation, the fly camera and the runtime toggles, displayed either
  * interactive: a matplotlib window with key bindings (needs matplotlib
    with a GUI backend), or
  * headless: render N accumulation batches and write PNG frames.

Runtime controls (interactive; `apply_key` holds the bindings):
  w/a/s/d/q/e move, arrows look, shift faster
  n neural toggle, l lambert toggle, b/shift+b bounces -/+,
  p/shift+p spp -/+, x denoiser toggle, m classic-mesh cycle
  (original/inner/outer), r/shift+r envmap rotation -/+15deg,
  v/shift+v env strength x0.8/x1.25, g direct-env-color toggle,
  f/shift+f FOV -/+0.05 rad, t per-stage timing table (ms, ns/ray),
  i mesh/BVH/network memory stats, c print camera matrix JSON
  (shift+c writes camera_export.json), o save PNG (both into --output),
  u pause/resume live training (with --train-steps), h help, esc quit

Train-while-render (--train-steps N): N optimizer steps of the port's
trainer (segment sampling against the ground-truth mesh on the device,
train/trainer.py) run before each frame and the network is pushed into
the renderer, which restarts the neural accumulation. It warm-starts from
the weights loaded into the renderer, or resumes a checkpoint of this
package's trainer (--train-resume; an orbax directory is refused).

--bench-motion S measures interactivity without a display: S seconds of an
orbiting camera at the motion-drop preview size, then the config's sample
count at full size.

--dp N renders in pixel stripes over N ranks that the command spawns
(parallel/launch.py; `--device cpu` runs them on the CPU over gloo), the
denoiser through its tiled form. Every rank renders alike; rank 0 prints,
writes the PNGs, runs the window and sends its view settings to the other
ranks before each frame. Train-while-render runs the dp step of `train
--dp`: the ranks share each batch and hold one network, which every rank
pushes into its renderer.

Usage: python -m neural_renderer_tpu_torch.cli.viewer <config.json>
         [--headless N] [--output DIR] [--width W --height H] [--spp N]
         [--train-steps N --train-batch B --train-lr LR
          --train-ckpt-dir DIR --train-resume CKPT]
         [--bench-motion S --motion-drop D --chunk-batches N]
         [--ckpt FILE] [--dp N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import sys
import time

import numpy as np


class MotionScaler:
    """Interactive-preview resolution: while the camera moves, render at
    1/`drop` resolution (drop^2 fewer rays); `hold` seconds after the last
    motion, go back to full resolution and let the accumulation refine."""

    def __init__(self, width: int, height: int, drop: int = 4,
                 hold: float = 0.25):
        self.full = (width, height)
        drop = max(1, int(drop))
        # Even preview dimensions.
        self.preview = self.full if drop == 1 else (
            max(2, width // drop // 2 * 2), max(2, height // drop // 2 * 2))
        self.hold = hold
        self._last_motion = -1e30

    def update(self, moving: bool, now: float) -> tuple[int, int]:
        if moving:
            self._last_motion = now
        if now - self._last_motion < self.hold and self.preview != self.full:
            return self.preview
        return self.full

    def upscale(self, img: np.ndarray) -> np.ndarray:
        """Nearest-upscale a preview frame to the full display size."""
        if img.shape[0] == self.full[1]:
            return img
        ys = (np.arange(self.full[1]) * img.shape[0]) // self.full[1]
        xs = (np.arange(self.full[0]) * img.shape[1]) // self.full[0]
        return img[ys[:, None], xs[None, :]]


def build_renderer(args):
    """(config, Renderer, InputController, current_basis) for the config
    and flags: the scene (a UV sphere where the original mesh fails to
    load), the size, bounces, spp, weights and the config's camera."""
    from ..config import load_config, matrix_to_camera_state
    from ..render.renderer import RenderBasis, Renderer
    from ..scene.scene import Scene
    from .input_controller import CameraState, InputController

    cfg = load_config(args.config)
    scene = Scene.from_config(cfg, sphere_fallback=True)
    print(f"Loaded original mesh: {scene.original_mesh.num_triangles} "
          "triangles")

    renderer = Renderer(scene, cfg.neural_network, device=args.device)
    renderer.set_device_mesh(getattr(args, "mesh", None))
    renderer.resize(args.width or cfg.rendering.width,
                    args.height or cfg.rendering.height)
    renderer.set_bounce_count(cfg.rendering.bounce_count)
    renderer.set_samples_per_pixel(args.spp)
    renderer.set_use_neural_query(cfg.neural_network.use_neural_query)
    renderer.set_envmap_rotation(cfg.environment.rotation)
    renderer.set_constant_neural_color(cfg.material.use_constant_neural_color,
                                       cfg.material.constant_neural_color)
    ckpt = args.ckpt or cfg.checkpoint_path
    if ckpt:
        if renderer.load_weights_from_file(ckpt):
            print(f"Loaded checkpoint: {ckpt}")
        elif args.ckpt:
            raise SystemExit(1)  # an explicit --ckpt must not be ignored

    pos, yaw, pitch = matrix_to_camera_state(cfg.camera.matrix)
    camera = CameraState(position=pos * cfg.original_mesh.scale, yaw=yaw,
                         pitch=pitch, fov_y=cfg.camera.yfov)
    controller = InputController(camera)
    # Move speed: the config's, else 0.15 x the bounding-box diagonal.
    if cfg.camera.move_speed > 0:
        controller.set_move_speed(cfg.camera.move_speed)
    else:
        bmin, bmax = scene.original_mesh.bounds()
        controller.set_move_speed(
            0.15 * float(np.linalg.norm(bmax - bmin)) or 1.0)

    def current_basis():
        b = controller.basis
        return RenderBasis(b.forward, b.right, b.up, controller.camera.fov_y)

    return cfg, renderer, controller, current_basis


class LiveTrainer:
    """Train-while-render: `steps_per_frame` optimizer steps per call of
    run(), then the network is pushed into the renderer. The sampler,
    losses and AdamW are the train CLI's (train/trainer.py); with a device
    mesh (every rank builds one) the step is the meshed one: the ranks
    split each batch's rows and update one network."""

    def __init__(self, scene, renderer, steps_per_frame: int,
                 batch_size: int = 16384, lr: float = 1e-3,
                 resume: str = "", seed: int = 0, warm_start: bool = False,
                 mesh=None):
        import torch

        from ..train import (TrainConfig, init_train_state, make_optimizer,
                             make_train_step, restore_checkpoint,
                             scene_global_row, segment_domain)
        from ..train.trainer import TrainState

        dev = renderer.device
        self.renderer = renderer
        self.steps_per_frame = steps_per_frame
        self.enabled = True
        self.last_metrics: dict = {}
        tcfg = TrainConfig(batch_size=batch_size, learning_rate=lr)
        if resume:
            self.state = restore_checkpoint(resume, tcfg,
                                            renderer.net_config, dev)
        elif warm_start:
            # Fine-tune a copy of the weights being viewed, with a fresh
            # optimizer.
            net = copy.deepcopy(renderer.net).requires_grad_(True)
            opt, sched = make_optimizer(tcfg, net.parameters())
            self.state = TrainState(net, opt, sched, 0)
        else:
            self.state = init_train_state(tcfg, renderer.net_config, dev)
        if mesh is not None:
            from ..parallel import shard_train_state
            self.state = shard_train_state(self.state, mesh)
        omin, inv_extent, radius = segment_domain(scene, dev)
        self.step_fn = make_train_step(
            tcfg, renderer.net_config, scene.original_mesh.to_tensors(dev),
            scene.outer_shell.to_tensors(dev),
            scene.inner_shell.to_tensors(dev), omin, inv_extent, radius,
            global_row=scene_global_row(scene, dev), device=dev, mesh=mesh)
        # Seeded alike on every rank: the meshed step draws the same rays.
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)

    def run(self) -> dict:
        """One frame's worth of training; returns the last step's losses."""
        metrics = None
        for _ in range(self.steps_per_frame):
            self.state, metrics = self.step_fn(self.state, self.generator)
        if metrics is not None:
            self.last_metrics = {k: float(v) for k, v in metrics.items()}
        net = self.state.net
        self.renderer.set_network(net.gather() if hasattr(net, "gather")
                                  else net)
        return self.last_metrics

    def save(self, ckpt_dir: str) -> str:
        from ..train import save_checkpoint
        return save_checkpoint(ckpt_dir, self.state)


def make_live_trainer(args, cfg, scene, renderer):
    """The LiveTrainer when --train-steps > 0, else None. Raises
    ValueError for a --train-resume it cannot read."""
    if args.train_steps <= 0:
        return None
    if (scene.original_mesh.num_triangles == 0
            or scene.outer_shell.num_triangles == 0):
        print("train-while-render needs an original mesh and outer shell; "
              "training disabled", file=sys.stderr)
        return None
    # Warm-start whenever weights were loaded into the renderer, unless a
    # train state is resumed.
    warm = renderer.net is not None and not args.train_resume
    trainer = LiveTrainer(scene, renderer, args.train_steps,
                          batch_size=args.train_batch, lr=args.train_lr,
                          resume=args.train_resume, warm_start=warm,
                          mesh=getattr(args, "mesh", None))
    print(f"Live training: {args.train_steps} steps/frame, batch "
          f"{args.train_batch}" + (" (warm start)" if warm else ""))
    return trainer


def _lead(args) -> bool:
    """Whether this process prints and writes: rank 0, or the only one."""
    mesh = getattr(args, "mesh", None)
    return mesh is None or mesh.get_rank() == 0


def _agree(args, value):
    """Rank 0's `value` on every rank (the value itself without a mesh)."""
    if getattr(args, "mesh", None) is None:
        return value
    import torch.distributed as dist
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def run_headless(args):
    cfg, renderer, controller, current_basis = build_renderer(args)
    os.makedirs(args.output, exist_ok=True)
    from ..metrics import save_png

    trainer = make_live_trainer(args, cfg, renderer.scene, renderer)
    renderer.set_camera_basis(current_basis())
    for i in range(args.headless):
        loss = ""
        if trainer is not None:
            t0 = time.perf_counter()
            m = trainer.run()
            rate = trainer.steps_per_frame / (time.perf_counter() - t0)
            loss = (f", loss {m.get('total', float('nan')):.4f} "
                    f"({rate:.2f} train steps/s)")
        img = renderer.render(controller.camera.position)
        fps = 1.0 / max(renderer.last_frame_seconds, 1e-9)
        print(f"frame {i}: {renderer.accum_sample_count} spp accumulated, "
              f"{renderer.mrays_per_second:.1f} Mrays/s, {fps:.2f} fps{loss}")
        if args.save_sequence and _lead(args):
            save_png(os.path.join(args.output, f"frame_{i:04d}.png"), img)
    if _lead(args):
        save_png(os.path.join(args.output, "viewer_final.png"),
                 renderer.device_pixels())
    if trainer is not None and args.train_ckpt_dir:
        print(f"checkpoint: {trainer.save(args.train_ckpt_dir)}")
    return 0


def run_motion_bench(args):
    """Interactivity without a display: orbit the camera for
    `--bench-motion` seconds at the MotionScaler preview size (the
    accumulation restarts every frame), then rest and accumulate the
    config's total_samples at full size. Prints the preview fps and median
    frame time, and the rest's Mrays/s. With --train-steps, training runs
    before each motion frame."""
    cfg, renderer, controller, current_basis = build_renderer(args)
    width, height = renderer.width, renderer.height
    scaler = MotionScaler(width, height, drop=args.motion_drop)
    trainer = make_live_trainer(args, cfg, renderer.scene, renderer)
    pw, ph = scaler.preview

    # Warm up both sizes outside the timed loops.
    renderer.set_camera_basis(current_basis())
    renderer.resize(pw, ph)
    renderer.render(controller.camera.position)
    renderer.resize(width, height)
    renderer.render(controller.camera.position)

    pos0 = np.array(controller.camera.position, np.float64)
    radius = float(np.linalg.norm(pos0)) or 1.0
    renderer.resize(pw, ph)
    frame_times = []
    t0 = time.perf_counter()
    t_end = t0 + args.bench_motion
    while _agree(args, time.perf_counter() < t_end):
        ang = 0.2 * (time.perf_counter() - t0)
        pos = np.array([radius * math.sin(ang), pos0[1],
                        radius * math.cos(ang)])
        if trainer is not None:
            trainer.run()
        f0 = time.perf_counter()
        img = renderer.render(pos)
        frame_times.append(time.perf_counter() - f0)
        scaler.upscale(img)  # the preview path's host cost, counted
    motion_wall = time.perf_counter() - t0
    frames = len(frame_times)
    frame_times.sort()
    med = frame_times[frames // 2] if frame_times else 0.0
    print(f"motion: {frames} frames in {motion_wall:.2f} s at {pw}x{ph} "
          f"(drop {args.motion_drop}) -> {frames / motion_wall:.2f} fps "
          f"(median frame {med * 1e3:.1f} ms, incl. pixel readback"
          + (f", {args.train_steps} train steps/frame" if trainer else "")
          + ")")

    renderer.resize(width, height)
    renderer.reset_samples()
    total = cfg.rendering.total_samples
    t0 = time.perf_counter()
    img = renderer.render_accumulate(controller.camera.position, total,
                                     batch_spp=args.spp,
                                     chunk_batches=args.chunk_batches)
    rest_wall = time.perf_counter() - t0
    rays = width * height * total
    print(f"rest: {total} spp at {width}x{height} converged in "
          f"{rest_wall:.2f} s ({rays / rest_wall / 1e6:.3f} Mrays/s)")
    batches = max(total // args.spp, 1)
    sfps = batches / max(renderer.last_frame_seconds, 1e-9)
    print(f"full-res single-batch rate: {sfps:.2f} batches/s at spp "
          f"{args.spp}")
    from ..metrics import save_png
    if _lead(args):
        os.makedirs(args.output, exist_ok=True)
        save_png(os.path.join(args.output, "bench_motion_final.png"), img)
    return 0


def profile_table(renderer, controller):
    """The per-stage timing table for the current camera and settings."""
    from ..render.profiler import profile_renderer
    return profile_renderer(renderer, controller.camera.position,
                            renderer.use_neural_query).table()


# Held keys -> the controller's movement names.
MOVE_KEYS = {"w": "w", "a": "a", "s": "s", "d": "d", "q": "q", "e": "e",
             " ": "space", "shift": "shift", "control": "ctrl"}


def apply_key(renderer, controller, key: str, pressed: set | None = None,
              trainer=None, out_dir: str = ".") -> bool:
    """Apply one key press (matplotlib's key names) to the renderer,
    camera and trainer; returns True when the viewer should quit. Held
    movement keys go into `pressed`."""
    k = (key or "").lower()
    if k == "escape":
        return True
    if k in MOVE_KEYS:
        if pressed is not None:
            pressed.add(MOVE_KEYS[k])
    elif k in ("up", "down", "left", "right"):
        dx, dy = {"up": (0, 20), "down": (0, -20), "left": (-20, 0),
                  "right": (20, 0)}[k]
        controller.apply_mouse_delta(dx, dy)
    elif k == "n":
        renderer.set_use_neural_query(not renderer.use_neural_query)
    elif k == "l":
        renderer.set_lambert_view(not renderer.lambert_view)
    elif k == "x":
        renderer.set_denoise(not renderer.denoise)
    elif k == "b":
        renderer.set_bounce_count(max(0, renderer.bounce_count - 1))
    elif k == "shift+b":
        renderer.set_bounce_count(renderer.bounce_count + 1)
    elif k == "p":
        renderer.set_samples_per_pixel(
            max(1, renderer.samples_per_pixel - 1))
    elif k == "shift+p":
        renderer.set_samples_per_pixel(renderer.samples_per_pixel + 1)
    elif k in ("c", "shift+c"):
        from ..config import camera_state_to_matrix
        cam = controller.camera
        m = camera_state_to_matrix(cam.position, cam.yaw, cam.pitch)
        blob = json.dumps({"matrix": [float(v) for v in m],
                           "yfov": cam.fov_y})
        if k == "shift+c":
            path = os.path.join(out_dir, "camera_export.json")
            with open(path, "w") as f:
                f.write(blob)
            print(f"saved {path}")
        else:
            print(blob)
    elif k == "o":
        from ..metrics import save_png
        save_png(os.path.join(out_dir, "viewer_capture.png"),
                 renderer.device_pixels())
    elif k == "m":
        renderer.set_classic_mesh_index((renderer.classic_mesh_index + 1)
                                        % 3)
    elif k == "r":
        renderer.set_envmap_rotation(renderer.envmap_rotation - 15.0)
    elif k == "shift+r":
        renderer.set_envmap_rotation(renderer.envmap_rotation + 15.0)
    elif k == "v":
        renderer.set_env_strength(renderer.env_strength * 0.8)
    elif k == "shift+v":
        renderer.set_env_strength(renderer.env_strength * 1.25)
    elif k == "g":
        renderer.set_direct_env_color(not renderer.use_direct_env_color,
                                      renderer.direct_env_color)
    elif k == "f":
        controller.camera.fov_y = max(0.1, controller.camera.fov_y - 0.05)
    elif k == "shift+f":
        controller.camera.fov_y = min(3.0, controller.camera.fov_y + 0.05)
    elif k == "u":
        if trainer is not None:
            trainer.enabled = not trainer.enabled
            print(f"training {'resumed' if trainer.enabled else 'paused'}")
    elif k == "t":
        print(profile_table(renderer, controller))
    elif k == "i":
        print(json.dumps(renderer.memory_stats(), indent=2))
    elif k == "h":
        print(__doc__)
    return False


def gui_problem():
    """Why no window can open (a message), or None."""
    try:
        import matplotlib
        import matplotlib.pyplot  # noqa: F401
    except ImportError:
        return "matplotlib unavailable; use --headless"
    backend = matplotlib.get_backend().lower()
    # A file-output backend cannot open a window.
    if backend in ("agg", "pdf", "svg", "svgz", "ps", "eps", "cairo",
                   "template", "pgf") or "inline" in backend:
        return (f"no GUI backend (matplotlib is on {backend}) — "
                "use --headless N")
    return None


# The Renderer's view settings rank 0 sends to the other ranks per frame.
VIEW_STATE = ("use_neural_query", "lambert_view", "bounce_count",
              "samples_per_pixel", "classic_mesh_index", "envmap_rotation",
              "env_strength", "use_additional_mesh",
              "use_constant_neural_color", "constant_neural_color",
              "use_direct_env_color", "direct_env_color", "denoise")


def _follow(args):
    """A rank other than 0 in the interactive mode: render rank 0's view,
    frame by frame, until it quits."""
    cfg, renderer, controller, _ = build_renderer(args)
    trainer = make_live_trainer(args, cfg, renderer.scene, renderer)
    while True:
        view = _agree(args, None)
        if view is None:
            break
        settings, (w, h), basis, pos, training = view
        for k, v in settings.items():
            setattr(renderer, k, v)
        renderer.resize(w, h)
        renderer.set_camera_basis(basis)
        if trainer is not None and training:
            trainer.run()
        renderer.render(pos)
    # Rank 0 writes the checkpoint; its gather needs every rank.
    if trainer is not None and args.train_ckpt_dir:
        trainer.save(args.train_ckpt_dir)
    return 0


def run_interactive(args):
    if not _lead(args):
        return _follow(args)
    problem = gui_problem()
    if problem is not None:
        print(problem, file=sys.stderr)
        return 1
    import matplotlib.pyplot as plt

    cfg, renderer, controller, current_basis = build_renderer(args)
    trainer = make_live_trainer(args, cfg, renderer.scene, renderer)
    os.makedirs(args.output, exist_ok=True)
    pressed: set[str] = set()
    state = {"quit": False}

    def on_key(event):
        if apply_key(renderer, controller, event.key, pressed, trainer,
                     args.output):
            state["quit"] = True

    def on_release(event):
        k = (event.key or "").lower()
        if k in MOVE_KEYS:
            pressed.discard(MOVE_KEYS[k])

    fig, ax = plt.subplots(figsize=(10, 6))
    fig.canvas.mpl_connect("key_press_event", on_key)
    fig.canvas.mpl_connect("key_release_event", on_release)
    im = ax.imshow(np.zeros((renderer.height, renderer.width, 3), np.uint8))
    ax.axis("off")
    plt.ion()
    plt.show()

    scaler = MotionScaler(renderer.width, renderer.height,
                          drop=args.motion_drop)
    last = time.monotonic()
    while not state["quit"] and plt.fignum_exists(fig.number):
        now = time.monotonic()
        dt = now - last
        last = now
        if pressed:
            controller.apply_keys(pressed, dt)
        renderer.set_camera_basis(current_basis())
        # Drop the resolution while flying, restore it at rest.
        w, h = scaler.update(bool(pressed), now)
        renderer.resize(w, h)
        training = trainer is not None and trainer.enabled
        # The view goes out before the training step, whose collectives
        # the other ranks then meet in the same order (_follow).
        _agree(args, ({k: getattr(renderer, k) for k in VIEW_STATE}, (w, h),
                      renderer.basis, controller.camera.position, training))
        loss = ""
        if training:
            m = trainer.run()
            loss = f" | loss {m.get('total', float('nan')):.4f}"
        img = scaler.upscale(renderer.render(controller.camera.position))
        im.set_data(img)
        ax.set_title(f"{renderer.accum_sample_count} spp | "
                     f"{renderer.mrays_per_second:.0f} Mrays/s | "
                     f"neural={renderer.use_neural_query}{loss}")
        fig.canvas.draw_idle()
        fig.canvas.flush_events()
    _agree(args, None)
    if trainer is not None and args.train_ckpt_dir:
        print(f"checkpoint: {trainer.save(args.train_ckpt_dir)}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Interactive neural renderer viewer")
    parser.add_argument("config")
    parser.add_argument("--headless", type=int, default=0, metavar="N",
                        help="render N accumulation batches without a window")
    parser.add_argument("--output", default="viewer_output")
    parser.add_argument("--save-sequence", action="store_true")
    parser.add_argument("--width", type=int, default=0)
    parser.add_argument("--height", type=int, default=0)
    parser.add_argument("--spp", type=int, default=1)
    parser.add_argument("--motion-drop", type=int, default=4,
                        help="divide the resolution by this while the "
                             "camera moves (1 disables)")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel ranks: pixel stripes over N "
                             "processes (multi-GPU)")
    parser.add_argument("--train-steps", type=int, default=0, metavar="N",
                        help="train-while-render: N optimizer steps per frame")
    parser.add_argument("--train-batch", type=int, default=16384)
    parser.add_argument("--train-lr", type=float, default=1e-3)
    parser.add_argument("--train-ckpt-dir", default="",
                        help="write a checkpoint <name>_step<N>.npz (and "
                             ".adam.npz) on exit")
    parser.add_argument("--train-resume", default="",
                        help="checkpoint of this package's trainer to resume")
    parser.add_argument("--ckpt", default="",
                        help="weights to load (an .npz, or the flat FP16 "
                             "blob of a tcnn-layout network), overriding "
                             "the config's checkpoint_path")
    parser.add_argument("--bench-motion", type=float, default=0.0,
                        metavar="SECONDS",
                        help="orbit the camera for SECONDS at the preview "
                             "size and report fps, then time the config's "
                             "sample count at full size (no display)")
    parser.add_argument("--chunk-batches", type=int, default=64,
                        help="bench-motion rest: batches between "
                             "synchronisations")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.dp < 1:
        print("viewer: --dp (multi-GPU pixel stripes) must be at least 1",
              file=sys.stderr)
        return 1
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("viewer: no CUDA device found; this program runs on the GPU "
              "(pass --device cpu for a small CPU run)", file=sys.stderr)
        return 1
    if args.dp > 1:
        if args.bench_motion <= 0 and args.headless <= 0:
            problem = gui_problem()
            if problem is not None:
                print(problem, file=sys.stderr)
                return 1
        from ..parallel.launch import describe, spawn
        print(f"viewer: pixel stripes over {describe(args.dp, args.device)}",
              file=sys.stderr)
        return max(spawn(_rank_run, args.dp, args.device, args))
    return dispatch(args)


def _rank_run(rank, world, device, args) -> int:
    # A rank's error propagates, ending every rank.
    from ..parallel import make_mesh
    args.device = str(device)
    args.mesh = make_mesh(dp=world, tp=1)
    return _mode(args)


def _mode(args) -> int:
    if args.bench_motion > 0:
        return run_motion_bench(args)
    if args.headless > 0:
        return run_headless(args)
    return run_interactive(args)


def dispatch(args) -> int:
    """The viewer mode the flags select, on this process's device."""
    try:
        return _mode(args)
    except (RuntimeError, ValueError) as e:
        print(f"viewer: {e}", file=sys.stderr)
        return 1

if __name__ == "__main__":
    sys.exit(main())
