"""Rank functions for the port's multi-rank CPU tests (gloo).

Each runs inside `neural_renderer_tpu_torch.parallel.launch.spawn` on every
rank and returns what the test compares with the single-process result;
the tests' modules spawn the world once and hold every result. The inputs
are made here from seeds, the same in every rank and in the test process,
and this module imports torch and the port only (the ranks start without
JAX)."""

import contextlib
import io

import torch

from neural_renderer_tpu_torch.models import nbvh
from neural_renderer_tpu_torch.render.neural_march import NeuralContext
from neural_renderer_tpu_torch.render.params import RenderParams
from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
from neural_renderer_tpu_torch.scene.materials import Material
from neural_renderer_tpu_torch.scene.mesh import outward_sphere

# 32 x 24, 2 bounces, 4 stripes of 6 rows (the denoiser's radius is 5).
W, H, BOUNCES = 32, 24, 2
CAM = dict(cam_pos=[0, 0, 3.0], cam_forward=[0, 0, -1.0],
           cam_right=[1, 0, 0.0], cam_up=[0, 1, 0.0], fov_y=0.9,
           scene_scale=2.0)


def render_scene(device="cpu"):
    """(ctx, gt mesh, env, params(offset)): shells (24, 48) of radius 1.2
    and 0.8 around a sphere of 1.0, a seeded lane network (S=4) with
    tables scaled to visible values."""
    om = outward_sphere(24, 48, 1.2)
    outer = om.to_tensors(device)
    inner = outward_sphere(24, 48, 0.8).to_tensors(device)
    gt = outward_sphere(16, 32, 1.0).to_tensors(device)
    net = nbvh.init_params(nbvh.NbvhConfig(lane_sublanes=4),
                           torch.Generator().manual_seed(0), device)
    with torch.no_grad():
        net.lane.mul_(1e3)
    omin, omax = om.bounds()
    env = EnvironmentTensors.from_numpy(None, device=device)

    def params(offset=0, w=W, h=H, bounces=BOUNCES):
        return RenderParams.make(
            w, h, 1, bounces, sample_offset=offset, device=device,
            material=Material(roughness=0.6, specular=0.3),
            outer_shell_min=omin, outer_shell_inv_extent=1.0 / (omax - omin),
            **CAM)
    return NeuralContext(outer, inner, net), gt, env, params


def render_checks(rank, world, device):
    """Two accumulation batches of the tiled GT and neural frames (guides
    on the second), the tiled denoiser on the neural accumulation,
    psnr_tiled of the two images, the Renderer's tiled frames and its
    fallbacks. Every rank returns its stripes of the accumulation and the
    guides; the images are equal on all ranks."""
    from neural_renderer_tpu_torch import parallel as par
    mesh = par.make_mesh(dp=world, tp=1)
    ctx, gt, env, params = render_scene(device)
    rows = H // world
    out = {}
    for name, frame in (
            ("gt", lambda p, acc, g: par.render_gt_frame_tiled(
                gt, env, p, acc, mesh, return_guides=g)),
            ("neural", lambda p, acc, g: par.render_neural_frame_tiled(
                ctx, env, p, acc, mesh, return_guides=g))):
        img0, acc = frame(params(0), torch.zeros((3, W * rows)), False)
        img, acc, guides = frame(params(1), acc, True)
        out[name] = dict(img0=img0, img=img, acc=acc, guides=guides)
    acc = out["neural"]["acc"].reshape(3, rows, W)
    out["denoised"] = par.bilateral_denoise_tiled(
        acc, 2, *out["neural"]["guides"], mesh)
    out["psnr"] = float(par.psnr_tiled(out["gt"]["img"],
                                       out["neural"]["img"], mesh))
    out["renderer"] = renderer_frames(mesh, device)
    out["fallback"] = renderer_fallbacks(mesh, device)
    return out


def tiny_scene():
    from neural_renderer_tpu_torch.scene.scene import Scene
    return Scene(original_mesh=outward_sphere(8, 16, 1.0),
                 inner_shell=outward_sphere(6, 12, 0.8),
                 outer_shell=outward_sphere(6, 12, 1.2))


def renderer_frames(mesh=None, device="cpu"):
    """Three frames of a Renderer on tiny_scene at 16x24 (a device mesh
    set, or one process; 4 stripes of 6 rows, over the denoiser's radius),
    two plain then one denoised, and render_accumulate of 2 samples. Returns the images and the accumulation's pixel count
    after each."""
    from neural_renderer_tpu_torch.render.renderer import Renderer
    rend = Renderer(tiny_scene(), device=device)
    rend.set_device_mesh(mesh)
    rend.set_bounce_count(1)
    rend.resize(16, 24)
    frames = []
    for denoise in (False, False, True):
        rend.set_denoise(denoise)
        frames.append((rend.render([0.0, 0.2, 3.0]),
                       rend._accum.shape[-1]))
    rend.set_denoise(False)
    frames.append((rend.render_accumulate([0.0, 0.2, 3.0], 2),
                   rend._accum.shape[-1]))
    return dict(frames=frames,
                fallback=rend.memory_stats()["tiled_fallback_frames"])


def renderer_fallbacks(mesh, device):
    """Frames of a Renderer with the mesh set that fall back: two Lambert
    frames, one of a height the stripes do not divide, one denoised frame
    of 4-row stripes; then a tiled frame. Returns the fallback count after
    each frame and the warnings printed."""
    from neural_renderer_tpu_torch.render.renderer import Renderer
    rend = Renderer(tiny_scene(), device=device)
    rend.set_device_mesh(mesh)
    rend.set_bounce_count(1)
    counts, err = [], io.StringIO()
    with contextlib.redirect_stderr(err):
        for lambert, denoise, (w, h) in ((True, False, (16, 16)),
                                         (True, False, (16, 16)),
                                         (False, False, (16, 18)),
                                         (False, True, (16, 16)),
                                         (False, False, (16, 16))):
            rend.set_lambert_view(lambert)
            rend.set_denoise(denoise)
            rend.resize(w, h)
            rend.render([0.0, 0.0, 3.0])
            counts.append(rend.memory_stats()["tiled_fallback_frames"])
    return dict(counts=counts, warnings=err.getvalue().splitlines(),
                stats=rend.memory_stats())


# The dryrun's tiny network; and the 4 x 128 network of K6's twin.
SMALL = dict(lane_sublanes=4, log2_hashmap_size=10, base_resolution=8)


def train_batch(config, b, seed=0, valid_split=False):
    """A seeded SegmentBatch; valid_split makes the first half of the rows
    valid and only every fourth row of the second half, so the ranks'
    valid counts differ."""
    from neural_renderer_tpu_torch.parallel.dryrun import tiny_batch
    batch = tiny_batch(config, b, seed)
    if valid_split:
        valid = torch.ones(b, dtype=torch.bool)
        valid[b // 2:] = torch.arange(b - b // 2) % 4 == 0
        batch = batch._replace(valid=valid)
    return batch


def train_net(config, seed=1):
    net = nbvh.init_params(config, torch.Generator().manual_seed(seed), "cpu")
    with torch.no_grad():
        net.lane.mul_(1e2)
    return net


def one_step(config, fused, batch, mesh=None, device="cpu"):
    """One step from train_net on `batch` (sharded with a mesh); returns
    (metrics, whole params, whole exp_avg, shard shapes, this rank's
    network and moment bytes)."""
    import copy

    from neural_renderer_tpu_torch import parallel as par
    from neural_renderer_tpu_torch.train import TrainConfig
    from neural_renderer_tpu_torch.train.trainer import (
        TrainState, _moments, make_optimizer, make_train_step_on_batch)
    cfg = TrainConfig(batch_size=batch.valid.shape[0], learning_rate=3e-3,
                      fused_kernel=fused)
    net = copy.deepcopy(train_net(config)).requires_grad_(True)
    opt, sched = make_optimizer(cfg, net.parameters())
    state = TrainState(net, opt, sched, 0)
    if mesh is not None:
        state = par.shard_train_state(state, mesh)
    state, metrics = make_train_step_on_batch(cfg, config, device,
                                              mesh)(state, batch)
    shards = [tuple(p.shape) for p in state.net.parameters()]
    whole = state.net.gather() if mesh is not None else state.net
    return ({k: float(v) for k, v in metrics.items()},
            [p.detach().clone() for p in whole.parameters()],
            _moments(state, "exp_avg"), shards,
            par.shardings.state_bytes(state))


def train_checks(rank, world, device):
    """dp2 x tp2 steps: the dryrun's tiny network (plain forward) and the
    4 x 128 network through apply_train (K2 / K6 twins), and the
    uneven-valid batch."""
    from neural_renderer_tpu_torch import parallel as par
    from neural_renderer_tpu_torch.parallel.dryrun import TINY
    mesh = par.make_mesh(dp=2, tp=2)
    tiny = nbvh.NbvhConfig(**TINY)
    small = nbvh.NbvhConfig(**SMALL)
    index = par.shardings.axis_coords(mesh, ("dp", "tp"))
    return dict(
        index=index,
        tiny=one_step(tiny, "off", train_batch(tiny, 64), mesh, device),
        small=one_step(small, "auto", train_batch(small, 128, 1), mesh,
                       device),
        split=one_step(small, "auto",
                       train_batch(small, 128, 2, valid_split=True), mesh,
                       device),
        rows=par.dp_shard_batch(train_batch(small, 130, 1), mesh,
                                ("dp", "tp")).valid.shape[0])
