"""The one general generator: the system under test and its calls, built
from a configuration file and a traffic mix's parameters.

Traffic kinds (the mix's "kind"):
  frames   the viewer's frame: `Renderer.render(cam_pos)` at `spp` samples
           a pixel, the accumulation running on from frame to frame (the
           sample offset advancing by spp), as the viewer does while the
           camera rests;
  batches  `evaluate`'s batch: `Renderer.render_accumulate(cam_pos,
           spp, batch_spp=spp)`, each call a fresh accumulation.
Both render `width` x `height` with `bounces` bounces, the neural query
on or off (`neural`), without the hybrid mesh and the denoiser, from the
config's camera. Every seed renders the same view at the same size; the
seed sets only the sample offsets and what the check compares.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass

import numpy as np


def camera_from_matrix(matrix):
    """(position [3], yaw_deg, pitch_deg) of a column-major world-to-
    camera matrix, as the scene files store the camera."""
    m = np.asarray(matrix, np.float64).reshape(-1)
    t = m[12:15]
    rot = np.array([[m[0], m[4], m[8]], [m[1], m[5], m[9]],
                    [m[2], m[6], m[10]]])
    pos = -(rot.T @ t)
    fwd = -rot[2]
    yaw = math.degrees(math.atan2(fwd[2], fwd[0]))
    pitch = math.degrees(math.atan2(fwd[1], math.hypot(fwd[0], fwd[2])))
    return pos.astype(np.float32), yaw, pitch


def camera_basis(yaw_deg: float, pitch_deg: float):
    """(forward, right, up) float32 of a yaw / pitch, world up +y."""
    yaw, pitch = math.radians(yaw_deg), math.radians(pitch_deg)
    fwd = np.array([math.cos(pitch) * math.cos(yaw), math.sin(pitch),
                    math.cos(pitch) * math.sin(yaw)])
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    rn = np.linalg.norm(right)
    right = np.array([1.0, 0.0, 0.0]) if rn < 1e-4 else right / rn
    up = np.cross(right, fwd)
    up /= np.linalg.norm(up)
    return (fwd.astype(np.float32), right.astype(np.float32),
            up.astype(np.float32))


@dataclass
class Camera:
    pos: np.ndarray
    forward: np.ndarray
    right: np.ndarray
    up: np.ndarray
    fov_y: float


def config_camera(matrix, fov_y: float) -> Camera:
    pos, yaw, pitch = camera_from_matrix(matrix)
    fwd, right, up = camera_basis(yaw, pitch)
    return Camera(pos, fwd, right, up, float(fov_y))


class Cell:
    """The renderer of one cell and its call. `call()` renders one call
    and returns its u8 image [H, W, 3] on the host (so it has ended on the
    device); `keep` holds what the check compares of it, `check` compares
    that with the reference once the window has closed; `streams(k)` gives
    call k's RNG streams (sample offset plus sample index) of every sample
    of a pixel."""

    def __init__(self, config_path: str, traffic: dict, seed: int, device,
                 program: bool = True):
        """program=False builds the traffic and camera alone (what the
        reference needs), without the renderer."""
        self.traffic = traffic
        self.kind = traffic["kind"]
        if self.kind not in ("frames", "batches"):
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        self.width, self.height = traffic["width"], traffic["height"]
        self.spp = int(traffic["spp"])
        self.bounces = int(traffic["bounces"])
        self.neural = bool(traffic["neural"])
        with open(config_path) as f:
            cam = json.load(f)["camera"]
        self.camera = config_camera(cam["matrix"], cam.get("yfov", 1.047198))
        self.calls = 0
        self.renderer = None
        if program:
            self._build(config_path, device)

    def _build(self, config_path: str, device):
        from neural_renderer_tpu_torch import config as nr_config
        from neural_renderer_tpu_torch.render.renderer import (RenderBasis,
                                                               Renderer)
        from neural_renderer_tpu_torch.scene.scene import Scene
        cfg = nr_config.load_config(config_path)
        r = Renderer(Scene.from_config(cfg), cfg.neural_network,
                     device=device)
        if self.neural and not r.load_weights_from_file(cfg.checkpoint_path):
            raise RuntimeError(f"weights {cfg.checkpoint_path} not loaded")
        c = self.camera
        r.set_camera_basis(RenderBasis(c.forward, c.right, c.up, c.fov_y))
        r.resize(self.width, self.height)
        r.set_bounce_count(self.bounces)
        r.set_use_neural_query(self.neural)
        r.set_use_additional_mesh(False)
        r.set_denoise(False)
        r.set_samples_per_pixel(self.spp)
        self.renderer = r

    @property
    def work_per_call(self) -> int:
        return self.width * self.height * self.spp

    def plan_check(self, spec: dict, seed: int):
        """Draw the compared pixels and early call from the seed."""
        from . import check
        self.pix, self.k_rel = check.draw(seed, self.width * self.height,
                                          int(spec["check_pixels"]),
                                          check.FIRST_CALLS)
        self.kept = {}
        self._early = self._last = None

    def keep(self, i: int, img):
        """Keep what the check needs of window call i's image: the drawn
        pixels of the drawn early call and of the latest."""
        from . import check
        k = self.calls - 1
        if self._last is not None and self._last != self._early:
            del self.kept[self._last]
        self.kept[k] = check.pick(img, self.pix)
        if i == self.k_rel:
            self._early = k
        self._last = k

    def check(self, config_path: str, spec: dict, device) -> dict:
        """Free the program, then compare the kept images with the
        reference's."""
        import gc

        import torch

        from . import check
        calls = sorted(self.kept)
        program = [self.kept[k] for k in calls]
        self.close()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        self.check_note = f"calls {calls}, {len(self.pix)} pixels"
        reference = check.reference_images(config_path, self, calls,
                                           self.pix, device)
        return check.compare(program, reference)

    def call(self):
        r = self.renderer
        if self.kind == "frames":
            img = r.render(self.camera.pos)
        else:
            img = r.render_accumulate(self.camera.pos, self.spp,
                                      batch_spp=self.spp)
        self.calls += 1
        return img

    def streams(self, k: int) -> list:
        """RNG streams of call k's samples of each pixel, in the order the
        call sums them."""
        base = k * self.spp if self.kind == "frames" else 0
        return [base + s for s in range(self.spp)]

    def accumulates(self) -> bool:
        return self.kind == "frames"

    def close(self):
        self.renderer = None


def network_sizes(config_path: str) -> dict:
    """The shell network's work per row and its fixed reads per call, from
    the configuration file's `neural_network` block: the lane grid of 3
    points x 8 levels x 4 features (S sublanes x pack x 128 entries each,
    read as bf16 words at pack 2, f32 at 1) and the bias-free MLP 112 ->
    4 x 128 -> 16 (bf16 weights). Each row reads its 12 f32 inputs and
    writes 16 f32 outputs."""
    with open(config_path) as f:
        nn = json.load(f)["neural_network"]
    dims = [3 * 8 * 4 + 16] + [128] * 4 + [16]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    pack = int(nn.get("lane_entry_pack", 2))
    table_bytes = (3 * 8 * 4 * int(nn["lane_sublanes"]) * pack * 128
                   * (2 if pack == 2 else 4))
    return {"macs_per_row": macs, "row_bytes": (12 + 16) * 4,
            "fixed_bytes": table_bytes + 2 * macs}


def make(config_path: str, traffic: dict, seed: int, device,
         program: bool = True):
    """The cell of a traffic mix's kind."""
    if traffic["kind"] == "train":
        from .train import TrainCell
        return TrainCell(config_path, traffic, seed, device, program)
    return Cell(config_path, traffic, seed, device, program)
