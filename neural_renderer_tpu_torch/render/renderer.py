"""Renderer: the stateful frame orchestrator.

Port of `neural_renderer_tpu/render/renderer.py`: built from a Scene and a
NeuralNetworkConfig, with `resize`, the `set_*` API, `render(cam_pos)` (one
accumulation batch, with the camera/setting change detection that resets
accumulation) and `render_accumulate` (a fixed number of samples from a
fresh accumulator). Branches: ground truth (on the classic mesh: the
original mesh or, for `set_classic_mesh_index` 1 or 2, a shell) and
neural, each path-traced or as the Lambert view, the neural one with the
hybrid additional mesh where the scene has one and `use_additional_mesh`
is on. With `set_denoise` a path-traced frame also returns its guide
buffers and the image is `bilateral_denoise` of the running accumulation.
The environment is the scene's map (or the procedural sky) with the
renderer's rotation and strength, or the direct colour on camera misses.
PyTorch runs eagerly, so `render_accumulate` is a plain loop over batches
with a synchronisation and a progress call after each chunk.

With `set_device_mesh` (one Renderer per rank, parallel/launch.py) a
path-traced frame renders this rank's stripe of pixel rows, keeps the
stripe of the accumulation and gathers only the u8 image
(parallel/shardings.py); a denoised frame runs the tiled denoiser. A
frame falls back to the whole frame on every rank when it is a Lambert
view, when the height does not split into the mesh's stripes, or when a
denoised stripe would be shorter than the stencil's radius: each reason is
warned once on stderr and counted in memory_stats()["tiled_fallback_frames"].

One difference from the JAX Renderer: a change of samples_per_pixel keeps
the accumulated samples (the image divides by the total count, so batches
of any size average correctly). The JAX Renderer restarts the accumulation,
so its evaluate host loop shows only the last batch of an uneven sample
count.
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
from ..ops.denoise import DENOISE_RADIUS, bilateral_denoise
from ..scene.scene import Scene
from ..utils import spans
from .neural_frame import render_neural_frame, render_neural_lambert
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
        self.classic_mesh_index = 0
        self.use_additional_mesh = True
        self.envmap_rotation = scene.environment.rotation
        self.env_strength = scene.environment.strength
        self.use_constant_neural_color = False
        self.constant_neural_color = (0.8, 0.8, 0.8)
        self.use_direct_env_color = False
        self.direct_env_color = (0.0, 0.0, 0.0)
        self.denoise = False
        self._guides = None

        self.basis = RenderBasis(np.array([0.0, 0.0, -1.0]),
                                 np.array([1.0, 0.0, 0.0]),
                                 np.array([0.0, 1.0, 0.0]), 1.047198)
        self._accum = None
        self._accum_sample_count = 0
        self._pixels = None
        self._mesh_cache = {}
        self._env_pixels = None
        self._last_state = None
        self._weights_version = 0
        self.last_frame_seconds = 0.0
        self.last_frame_rays = 0
        self.device_mesh = None
        self.mesh_axis = "dp"
        self._tiled_fallback_frames = 0
        self._tiled_fallback_warned = set()

    # -- setter API ------------------------------------------------------
    def resize(self, width: int, height: int):
        if width == self.width and height == self.height:
            return
        self.width, self.height = width, height
        self._accum = None
        self._pixels = None

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

    def set_classic_mesh_index(self, i: int):
        """The ground-truth branch's mesh: 0 the original, 1 the inner
        shell, 2 the outer shell (an empty shell falls back to the
        original)."""
        self.classic_mesh_index = int(i)

    def set_envmap_rotation(self, deg: float):
        self.envmap_rotation = float(deg)

    def set_env_strength(self, strength: float):
        self.env_strength = max(0.0, float(strength))

    def set_use_additional_mesh(self, v: bool):
        self.use_additional_mesh = bool(v)

    def set_constant_neural_color(self, use: bool, color=(0.8, 0.8, 0.8)):
        self.use_constant_neural_color = bool(use)
        self.constant_neural_color = tuple(color)

    def set_direct_env_color(self, use: bool, color=(0.0, 0.0, 0.0)):
        """Camera rays that miss see `color` instead of the environment."""
        self.use_direct_env_color = bool(use)
        self.direct_env_color = tuple(color)

    def set_denoise(self, v: bool):
        """Denoise path-traced frames with the joint bilateral filter."""
        self.denoise = bool(v)

    def set_device_mesh(self, mesh, axis: str = "dp"):
        """Render path-traced frames in pixel stripes over the `axis` ranks
        of `mesh` (parallel.make_mesh; every rank calls render alike); None
        goes back to the whole frame."""
        self.device_mesh = mesh
        self.mesh_axis = axis

    def _use_tiled(self) -> bool:
        """Whether this frame runs in stripes; a fallback reason is warned
        once and counted."""
        if self.device_mesh is None:
            return False
        n = self.device_mesh[self.mesh_axis].size()
        if n <= 1:
            return False
        reason = None
        if self.lambert_view:
            reason = "the Lambert view renders the whole frame"
        elif self.height % n:
            reason = f"height {self.height} not divisible by dp={n}"
        elif self.denoise and self.height // n < DENOISE_RADIUS:
            reason = ("denoised stripes need at least the stencil radius "
                      f"({DENOISE_RADIUS}) rows")
        if reason is None:
            return True
        self._tiled_fallback_frames += 1
        if reason not in self._tiled_fallback_warned:
            self._tiled_fallback_warned.add(reason)
            print("neural_renderer_tpu_torch: device mesh set but the frame "
                  f"falls back to the whole frame: {reason}",
                  file=sys.stderr)
        return False

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
        """New weights invalidate the samples accumulated with the old: the
        train-while-render loop pushes its network here after its steps
        (an in-place update of the same network needs the push too)."""
        self.net = net
        self._weights_version += 1

    def device_pixels(self) -> np.ndarray:
        """The last rendered u8 image [H, W, 3]."""
        if self._pixels is None:
            raise RuntimeError("no frame rendered yet")
        return self._pixels

    # -- internals -------------------------------------------------------
    def _mesh_tensors(self, name: str):
        if name not in self._mesh_cache:
            self._mesh_cache[name] = getattr(self.scene, name).to_tensors(
                self.device)
        return self._mesh_cache[name]

    def invalidate_meshes(self):
        self._mesh_cache.clear()

    def _classic_name(self) -> str:
        if self.classic_mesh_index == 1 \
                and self.scene.inner_shell.num_triangles > 0:
            return "inner_shell"
        if self.classic_mesh_index == 2 \
                and self.scene.outer_shell.num_triangles > 0:
            return "outer_shell"
        return "original_mesh"

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
                # samples_per_pixel is left out: batches of any size
                # average correctly (see the module docstring).
                self.use_neural_query, self.lambert_view, self.bounce_count,
                self.classic_mesh_index,
                self.envmap_rotation, self.env_strength,
                self.use_additional_mesh,
                self.use_constant_neural_color, self.constant_neural_color,
                self.use_direct_env_color, self.direct_env_color,
                # Weight pushes only invalidate frames that sample the
                # network.
                self._weights_version if self.use_neural_query else 0)

    def _build_params(self, cam_pos, sample_offset: int) -> RenderParams:
        smin, smax = getattr(self.scene, self._classic_name()).bounds()
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
            use_direct_env_color=self.use_direct_env_color,
            direct_env_color=self.direct_env_color,
            scene_scale=scene_scale, outer_shell_min=omin,
            outer_shell_inv_extent=inv_extent, device=self.device)

    def _frame_fn(self):
        """(frame, lambert) of the active branch:
        `frame(env, params, accum, return_guides, row0, n_rows) -> (img,
        accum[, guides])` and `lambert(env, params) -> img`."""
        if self.use_neural_query:
            if self.scene.outer_shell.num_triangles == 0:
                raise RuntimeError("neural query without an outer shell mesh")
            if self.net is None:
                raise RuntimeError("neural query without weights: call "
                                   "load_weights_from_file or set_network")
            ctx = NeuralContext(outer=self._mesh_tensors("outer_shell"),
                                inner=self._mesh_tensors("inner_shell"),
                                net=self.net)
            use_add = (self.use_additional_mesh
                       and self.scene.additional_mesh.num_triangles > 0)
            add = self._mesh_tensors("additional_mesh") if use_add else None

            def frame(env, params, accum, return_guides=False, row0=0,
                      n_rows=None):
                return render_neural_frame(
                    ctx, env, params, accum, use_additional=use_add,
                    additional_mesh=add, return_guides=return_guides,
                    row0=row0, n_rows=n_rows)

            def lambert(env, params):
                return render_neural_lambert(ctx, env, params,
                                             use_additional=use_add,
                                             additional_mesh=add)
        else:
            classic = self._mesh_tensors(self._classic_name())

            def frame(env, params, accum, return_guides=False, row0=0,
                      n_rows=None):
                return render_gt_frame(classic, env, params, accum,
                                       return_guides=return_guides,
                                       row0=row0, n_rows=n_rows)

            def lambert(env, params):
                return render_gt_lambert(classic, env, params)
        return frame, lambert

    def _rows(self, tiled: bool) -> tuple[int, int]:
        """(row0, rows) this process renders: its stripe, or every row."""
        if not tiled:
            return 0, self.height
        from ..parallel.shardings import stripe_rows
        return stripe_rows(self.device_mesh, self.height, self.mesh_axis)

    def _gather_rows(self, img):
        """The whole u8 image from every rank's stripe of rows."""
        from ..parallel.shardings import all_gather_cat
        return all_gather_cat(img, self.device_mesh.get_group(self.mesh_axis),
                              0)

    def _sync(self):
        if self.device.type == "cuda":
            with spans.span("sync.device"):
                torch.cuda.synchronize(self.device)

    # -- the frame -------------------------------------------------------
    def render(self, cam_pos) -> np.ndarray:
        """Render one accumulation batch; returns the current u8 image
        [H, W, 3]. Traced as the span `frame` (utils/spans.py), its set-up
        on the host as `frameParams`."""
        with spans.span("frame"):
            return self._render(cam_pos)

    @torch.no_grad()
    def _render(self, cam_pos) -> np.ndarray:
        if self.width <= 0 or self.height <= 0:
            raise RuntimeError("resize() must be called before render()")
        with spans.span("frameParams"):
            key = self._settings_key(cam_pos)
            if key != self._last_state:
                self.reset_samples()
            self._last_state = key

            tiled = self._use_tiled()
            # In stripes the accumulation is this rank's rows.
            row0, rows = self._rows(tiled)
            if self._accum is None or \
                    self._accum.shape[-1] != self.width * rows:
                self.reset_samples()
                self._accum = torch.zeros((3, self.width * rows),
                                          dtype=torch.float32,
                                          device=self.device)
            params = self._build_params(cam_pos, self._accum_sample_count)
            env = self._env_tensors()
            t0 = time.perf_counter()
            frame, lambert = self._frame_fn()
        if self.lambert_view:
            img = lambert(env, params)
            self._accum_sample_count = 0
        elif self.denoise:
            _, self._accum, self._guides = frame(env, params, self._accum,
                                                 True, row0, rows)
            self._accum_sample_count += self.samples_per_pixel
            accum = self._accum.reshape(3, rows, self.width)
            if tiled:
                from ..parallel import bilateral_denoise_tiled
                img = bilateral_denoise_tiled(
                    accum, self._accum_sample_count, *self._guides,
                    self.device_mesh, self.mesh_axis)
            else:
                img = bilateral_denoise(accum, self._accum_sample_count,
                                        *self._guides)
        else:
            img, self._accum = frame(env, params, self._accum, False, row0,
                                     rows)
            self._accum_sample_count += self.samples_per_pixel
            if tiled:
                img = self._gather_rows(img)
        with spans.span("sync.image"):
            img = img.cpu().numpy()
        self.last_frame_seconds = time.perf_counter() - t0
        self.last_frame_rays = self.width * self.height * \
            self.samples_per_pixel
        self._pixels = img
        return img

    @torch.no_grad()
    def render_accumulate(self, cam_pos, total_samples: int,
                          batch_spp: int = 1, chunk_batches: int = 64,
                          progress=None) -> np.ndarray:
        """Render `total_samples` samples per pixel in batches of
        `batch_spp`, from a fresh accumulator; returns the final u8 image
        [H, W, 3]. `progress(batches_done, batches_total)` fires after
        every `chunk_batches` batches and the last, each time after a
        synchronisation, so it tracks the device; the image does not depend
        on the chunking. The Lambert and denoised views have no
        accumulation loop: use render(). Traced: the set-up on the host as
        the span `frameParams`, each batch as `frame` (its parameters as
        `frameParams`), the last with the image (`finalize`) and its copy
        to the host."""
        if self.width <= 0 or self.height <= 0:
            raise RuntimeError("resize() must be called before render()")
        if self.lambert_view or self.denoise:
            raise ValueError("render_accumulate supports plain path-traced "
                             "frames only (no Lambert view, no denoise)")
        if total_samples % batch_spp != 0:
            raise ValueError(f"total_samples {total_samples} must be a "
                             f"multiple of batch_spp {batch_spp}")
        with spans.span("frameParams"):
            chunk_batches = max(1, int(chunk_batches))
            self.set_samples_per_pixel(batch_spp)
            self.reset_samples()
            # render()'s change detection must not blend into this buffer.
            self._last_state = None

            env = self._env_tensors()
            # In stripes each rank accumulates its rows; only the final u8
            # image is gathered.
            tiled = self._use_tiled()
            row0, rows = self._rows(tiled)
            accum = torch.zeros((3, self.width * rows),
                                dtype=torch.float32, device=self.device)
            frame, _ = self._frame_fn()
            n_total = total_samples // batch_spp
            self._sync()
        t0 = time.perf_counter()
        params = None
        for i in range(n_total):
            with spans.span("frame"):
                with spans.span("frameParams"):
                    # The offset advances as a uint32, like the sample
                    # counter of the RNG streams it seeds.
                    params = self._build_params(cam_pos,
                                                (i * batch_spp) & 0xFFFFFFFF)
                _, accum = frame(env, params, accum, row0=row0, n_rows=rows)
                if progress is not None and ((i + 1) % chunk_batches == 0
                                             or i + 1 == n_total):
                    self._sync()
                    progress(i + 1, n_total)
                if i + 1 == n_total:
                    with spans.span("finalize"):
                        img = accum_image(params, accum, total_samples)
                        if tiled:
                            img = self._gather_rows(img)
                    with spans.span("sync.image"):
                        img = img.cpu().numpy()
                    self._sync()
        self.last_frame_seconds = time.perf_counter() - t0
        self.last_frame_rays = self.width * self.height * total_samples
        self._accum = accum
        self._accum_sample_count = total_samples
        self._pixels = img
        return img

    def memory_stats(self) -> dict:
        """Bytes of the network and of each mesh's tensors on the device
        (the BVH: the packed nodes, cluster bounds and root box), with the
        keys of the JAX Renderer's memory panel."""
        def tensor_bytes(ts):
            return int(sum(t.numel() * t.element_size() for t in ts
                           if isinstance(t, torch.Tensor)))

        stats = {"network_bytes": 0 if self.net is None
                 else tensor_bytes(self.net.parameters())}
        mesh_total = bvh_total = 0
        for name in ("original_mesh", "inner_shell", "outer_shell",
                     "additional_mesh"):
            m = self._mesh_tensors(name)
            total = tensor_bytes(getattr(m, f.name)
                                 for f in dataclasses.fields(m))
            bvh = tensor_bytes((m.nodes_packed, m.cluster_bounds,
                                m.bounds_min, m.bounds_max))
            stats[name] = {"total_bytes": total, "bvh_bytes": bvh,
                           "triangles": m.num_triangles}
            mesh_total += total - bvh
            bvh_total += bvh
        stats["mesh_bytes"] = mesh_total
        stats["bvh_bytes"] = bvh_total
        stats["tiled_fallback_frames"] = self._tiled_fallback_frames
        if self.device_mesh is not None:
            import torch.distributed as dist
            from ..parallel.launch import ranks_per_gpu
            world = dist.get_world_size()
            stats["backend"] = dist.get_backend()
            stats["ranks_per_gpu"] = ranks_per_gpu(world, self.device)
        return stats

    @property
    def mrays_per_second(self) -> float:
        if self.last_frame_seconds <= 0:
            return 0.0
        return self.last_frame_rays / self.last_frame_seconds / 1e6
