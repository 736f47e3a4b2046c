"""Renderer: the stateful frame orchestrator.

Port of `neural_renderer_tpu/render/renderer.py`: built from a Scene and a
NeuralNetworkConfig, with `resize`, the `set_*` API, `render(cam_pos)` (one
accumulation batch, with the camera/setting change detection that resets
accumulation) and `render_accumulate` (a fixed number of samples from a
fresh accumulator). Branches: ground truth path-traced and Lambert, neural
path-traced, with the hybrid additional mesh where the scene has one and
`use_additional_mesh` is on. The environment is the scene's map (or the
procedural sky) with the renderer's rotation and strength. PyTorch runs
eagerly, so `render_accumulate` is a plain loop over batches. The neural
Lambert view, denoising and the tiled multi-device paths are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import NeuralNetworkConfig
from ..models import convert, nbvh
from ..scene.scene import Scene
from .neural_frame import render_neural_frame
from .neural_march import NeuralContext
from .params import RenderParams
from .pathtrace import accum_image, render_gt_frame, render_gt_lambert


@dataclass
class RenderBasis:
    """Camera basis."""
    forward: np.ndarray
    right: np.ndarray
    up: np.ndarray
    fov_y: float


def npz_for_checkpoint(path: str) -> str:
    """The exported weights file of a checkpoint path: an `.npz` is itself;
    an orbax directory `<dir>/<name>_ckpt/step_<N>` maps to
    `<dir>/<name>_step<N>.npz`."""
    if path.endswith(".npz"):
        return path
    m = re.fullmatch(r"(.*)_ckpt[/\\]step_(\d+)[/\\]?", path)
    if m is None:
        raise ValueError(
            f"'{path}' is neither an .npz nor <name>_ckpt/step_<N>; this "
            "package reads weights exported by "
            "scripts/export_lane_ckpt_npz.py")
    return f"{m.group(1)}_step{m.group(2)}.npz"


class Renderer:
    def __init__(self, scene: Scene,
                 nn_config: NeuralNetworkConfig | None = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer: no CUDA device; pass device='cpu' to run the "
                "PyTorch twins on the CPU")
        self.scene = scene
        nn_config = nn_config or NeuralNetworkConfig()
        self.net_config = nbvh.NbvhConfig.from_network_config(nn_config)
        self.net = None  # loaded by load_weights_from_file / set_network

        self.width = 0
        self.height = 0
        self.samples_per_pixel = 1
        self.bounce_count = 3
        self.use_neural_query = False
        self.lambert_view = False
        self.use_additional_mesh = True
        self.envmap_rotation = scene.environment.rotation
        self.env_strength = scene.environment.strength
        self.use_constant_neural_color = False
        self.constant_neural_color = (0.8, 0.8, 0.8)

        self.basis = RenderBasis(np.array([0.0, 0.0, -1.0]),
                                 np.array([1.0, 0.0, 0.0]),
                                 np.array([0.0, 1.0, 0.0]), 1.047198)
        self._accum = None
        self._accum_sample_count = 0
        self._mesh_cache = {}
        self._env_pixels = None
        self._last_state = None
        self._weights_version = 0
        self.last_frame_seconds = 0.0
        self.last_frame_rays = 0

    # -- setter API ------------------------------------------------------
    def resize(self, width: int, height: int):
        if width == self.width and height == self.height:
            return
        self.width, self.height = width, height
        self._accum = None

    def set_camera_basis(self, basis: RenderBasis):
        self.basis = basis

    def set_use_neural_query(self, v: bool):
        self.use_neural_query = bool(v)

    def set_lambert_view(self, v: bool):
        self.lambert_view = bool(v)

    def set_bounce_count(self, n: int):
        self.bounce_count = max(0, int(n))

    def set_samples_per_pixel(self, n: int):
        self.samples_per_pixel = max(1, int(n))

    def set_envmap_rotation(self, deg: float):
        self.envmap_rotation = float(deg)

    def set_use_additional_mesh(self, v: bool):
        self.use_additional_mesh = bool(v)

    def set_constant_neural_color(self, use: bool, color=(0.8, 0.8, 0.8)):
        self.use_constant_neural_color = bool(use)
        self.constant_neural_color = tuple(color)

    def reset_samples(self):
        self._accum = None
        self._accum_sample_count = 0

    @property
    def accum_sample_count(self) -> int:
        return self._accum_sample_count

    def load_weights_from_file(self, path: str) -> bool:
        """Load weights: a file that is not an `.npz` is the reference's
        flat FP16 blob, [hg | mlp] (tcnn-layout networks only; see
        nbvh.load_flat_blob); an `.npz` (this package's checkpoints, or
        scripts/export_lane_ckpt_npz.py's) loads either grid type, also
        when named by the orbax directory it stands beside (see
        npz_for_checkpoint)."""
        try:
            if os.path.isfile(path) and not path.endswith(".npz"):
                self.set_network(nbvh.load_flat_blob(
                    path, self.net_config, device=self.device))
                return True
            npz = npz_for_checkpoint(path)
            if not os.path.exists(npz):
                raise OSError(
                    f"{npz} not found; export the checkpoint first: python "
                    f"scripts/export_lane_ckpt_npz.py {path} {npz}")
            self.set_network(convert.params_from_numpy(
                convert.load_params_npz(npz), self.net_config,
                device=self.device))
            return True
        except (OSError, ValueError) as e:
            print(f"Failed to load weights '{path}': {e}", file=sys.stderr)
            return False

    def set_network(self, net: nbvh.ShellNetwork):
        """New weights invalidate the samples accumulated with the old."""
        self.net = net
        self._weights_version += 1

    # -- internals -------------------------------------------------------
    def _mesh_tensors(self, name: str):
        if name not in self._mesh_cache:
            self._mesh_cache[name] = getattr(self.scene, name).to_tensors(
                self.device)
        return self._mesh_cache[name]

    def _env_tensors(self):
        if self._env_pixels is None:
            # The map's pixels move to the device once.
            self._env_pixels = self.scene.environment.to_tensors(
                device=self.device)
        return dataclasses.replace(self._env_pixels,
                                   rotation=self.envmap_rotation,
                                   strength=self.env_strength)

    def _settings_key(self, cam_pos):
        def r5(v):
            return tuple(np.round(np.asarray(v, np.float64), 5))
        return (r5(cam_pos), r5(self.basis.forward), r5(self.basis.right),
                r5(self.basis.up), round(self.basis.fov_y, 5),
                self.use_neural_query, self.lambert_view, self.bounce_count,
                self.samples_per_pixel,
                self.envmap_rotation, self.env_strength,
                self.use_additional_mesh,
                self.use_constant_neural_color, self.constant_neural_color,
                # Weight pushes only invalidate frames that sample the
                # network.
                self._weights_version if self.use_neural_query else 0)

    def _build_params(self, cam_pos, sample_offset: int) -> RenderParams:
        smin, smax = self.scene.original_mesh.bounds()
        scene_scale = float(np.linalg.norm(smax - smin))
        if scene_scale < 1e-6:
            scene_scale = 1.0
        omin, omax = self.scene.outer_shell.bounds()
        extent = omax - omin
        inv_extent = np.where(extent != 0.0,
                              1.0 / np.where(extent == 0, 1, extent), 0.0)
        return RenderParams.make(
            width=self.width, height=self.height,
            samples_per_pixel=self.samples_per_pixel,
            max_bounces=self.bounce_count,
            cam_pos=cam_pos, cam_forward=self.basis.forward,
            cam_right=self.basis.right, cam_up=self.basis.up,
            fov_y=self.basis.fov_y, material=self.scene.global_material,
            sample_offset=sample_offset,
            use_constant_neural_color=self.use_constant_neural_color,
            constant_neural_color=self.constant_neural_color,
            scene_scale=scene_scale, outer_shell_min=omin,
            outer_shell_inv_extent=inv_extent, device=self.device)

    def _frame_fn(self):
        """(frame, lambert): `frame(env, params, accum) -> (img, accum)` of
        the active branch and, for the ground-truth branch, its Lambert
        view."""
        if self.use_neural_query:
            if self.scene.outer_shell.num_triangles == 0:
                raise RuntimeError("neural query without an outer shell mesh")
            if self.net is None:
                raise RuntimeError("neural query without weights: call "
                                   "load_weights_from_file or set_network")
            if self.lambert_view:
                raise NotImplementedError(
                    "the neural Lambert view (render_neural_lambert) is not "
                    "ported yet")
            ctx = NeuralContext(outer=self._mesh_tensors("outer_shell"),
                                inner=self._mesh_tensors("inner_shell"),
                                net=self.net)
            use_add = (self.use_additional_mesh
                       and self.scene.additional_mesh.num_triangles > 0)
            add = self._mesh_tensors("additional_mesh") if use_add else None
            return (lambda env, params, accum: render_neural_frame(
                ctx, env, params, accum, use_additional=use_add,
                additional_mesh=add)), None
        mesh = self._mesh_tensors("original_mesh")
        return (lambda env, params, accum: render_gt_frame(
            mesh, env, params, accum),
            lambda env, params: render_gt_lambert(mesh, env, params))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the frame -------------------------------------------------------
    @torch.no_grad()
    def render(self, cam_pos) -> np.ndarray:
        """Render one accumulation batch; returns the current u8 image
        [H, W, 3]."""
        if self.width <= 0 or self.height <= 0:
            raise RuntimeError("resize() must be called before render()")
        key = self._settings_key(cam_pos)
        if key != self._last_state:
            self.reset_samples()
        self._last_state = key

        params = self._build_params(cam_pos, self._accum_sample_count)
        env = self._env_tensors()
        if self._accum is None:
            self._accum = torch.zeros((3, self.width * self.height),
                                      dtype=torch.float32, device=self.device)
        t0 = time.perf_counter()
        frame, lambert = self._frame_fn()
        if self.lambert_view:
            img = lambert(env, params)
            self._accum_sample_count = 0
        else:
            img, self._accum = frame(env, params, self._accum)
            self._accum_sample_count += self.samples_per_pixel
        img = img.cpu().numpy()
        self.last_frame_seconds = time.perf_counter() - t0
        self.last_frame_rays = self.width * self.height * \
            self.samples_per_pixel
        return img

    @torch.no_grad()
    def render_accumulate(self, cam_pos, total_samples: int,
                          batch_spp: int = 1, progress=None) -> np.ndarray:
        """Render `total_samples` samples per pixel in batches of
        `batch_spp`, from a fresh accumulator; returns the final u8 image
        [H, W, 3]. `progress(batches_done, batches_total)` fires after each
        batch. The Lambert view has no accumulation: use render()."""
        if self.width <= 0 or self.height <= 0:
            raise RuntimeError("resize() must be called before render()")
        if self.lambert_view:
            raise ValueError("render_accumulate supports path-traced frames "
                             "only (no Lambert view)")
        if total_samples % batch_spp != 0:
            raise ValueError(f"total_samples {total_samples} must be a "
                             f"multiple of batch_spp {batch_spp}")
        self.set_samples_per_pixel(batch_spp)
        self.reset_samples()
        # render()'s change detection must not blend into this buffer.
        self._last_state = None

        env = self._env_tensors()
        accum = torch.zeros((3, self.width * self.height),
                            dtype=torch.float32, device=self.device)
        frame, _ = self._frame_fn()
        n_total = total_samples // batch_spp
        self._sync()
        t0 = time.perf_counter()
        params = None
        for i in range(n_total):
            # The offset advances as a uint32, like the sample counter of
            # the RNG streams it seeds.
            params = self._build_params(cam_pos,
                                        (i * batch_spp) & 0xFFFFFFFF)
            _, accum = frame(env, params, accum)
            if progress is not None:
                progress(i + 1, n_total)
        img = accum_image(params, accum, total_samples).cpu().numpy()
        self._sync()
        self.last_frame_seconds = time.perf_counter() - t0
        self.last_frame_rays = self.width * self.height * total_samples
        self._accum = accum
        self._accum_sample_count = total_samples
        return img

    @property
    def mrays_per_second(self) -> float:
        if self.last_frame_seconds <= 0:
            return 0.0
        return self.last_frame_rays / self.last_frame_seconds / 1e6
