"""Online training loop: AdamW, cosine schedule, `.npz` checkpoints.

Port of `neural_renderer_tpu/train/trainer.py`. Each step samples a fresh
segment batch against the ground-truth mesh on the device, then takes the
gradient of `shell_losses` and an AdamW update. On lane-grid networks the
gradient comes from `ops/lane_grid_train_kernel.py::apply_train` (K2 in
training layout forward, K6 backward); `fused_kernel="off"` differentiates
the plain PyTorch forward instead.

The optimizer has optax.adamw's semantics (b1 0.9, b2 0.999, eps 1e-8 added
outside the square root, decoupled weight decay on every parameter, the
learning rate of step t taken before the step count advances), and the
cosine schedule is optax.cosine_decay_schedule's. Checkpoints are this
package's own: the weights `.npz` of models/convert.py plus a file with the
Adam moments and the step. The tcnn-layout network, its flat-blob export and
the dp/tp mesh are not ported.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..models import convert, nbvh
from .dataset import sample_segment_batch
from .losses import shell_losses


@dataclass
class TrainConfig:
    batch_size: int = 16384
    learning_rate: float = 1e-3
    weight_decay: float = 1e-6
    steps: int = 2000
    compute_dtype: str = "bfloat16"
    seed: int = 0
    log_every: int = 100
    checkpoint_every: int = 1000
    # "constant" or "cosine" (decays to lr_end_factor * learning_rate over
    # `steps`).
    lr_schedule: str = "constant"
    lr_end_factor: float = 0.05
    # March each sampled ray this many segments deep (re-entries) and train
    # on all of them: non-convex shells (the knot) need it.
    segments_per_ray: int = 1
    # Lane-grid gradient path: "auto" = apply_train (the kernels on CUDA,
    # their twins on the CPU), "on" = the kernels (CUDA only), "off" =
    # autograd through the plain PyTorch forward.
    fused_kernel: str = "auto"


@dataclass
class TrainState:
    net: nbvh.ShellNetwork
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def scene_global_row(scene, device="cuda"):
    """The scene's global-material scalar row: what the renderer resolves
    material_id < 0 hits against, so the albedo the sampler must supervise
    untextured meshes with."""
    return torch.as_tensor(np.asarray(scene.global_material.scalar_row()),
                           dtype=torch.float32, device=device)


def segment_domain(scene, device="cuda"):
    """(outer_shell_min, outer_shell_inv_extent) as f32 [3] tensors, and the
    segment-sampling sphere radius (1.5x the outer-shell diagonal)."""
    omin, omax = scene.outer_shell.bounds()
    extent = omax - omin
    inv_extent = np.where(extent != 0,
                          1.0 / np.where(extent == 0, 1, extent), 0.0)
    radius = 1.5 * float(np.linalg.norm(omax - omin))
    return (torch.as_tensor(omin, dtype=torch.float32, device=device),
            torch.as_tensor(inv_extent, dtype=torch.float32, device=device),
            radius)


def lr_factor(cfg: TrainConfig):
    """Step t -> learning-rate factor (optax.cosine_decay_schedule with
    alpha = lr_end_factor over cfg.steps, or 1)."""
    if cfg.lr_schedule == "constant":
        return lambda t: 1.0
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule '{cfg.lr_schedule}'")
    steps, alpha = max(1, cfg.steps), cfg.lr_end_factor

    def factor(t):
        c = min(t, steps)
        return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / steps)) \
            + alpha
    return factor


def make_optimizer(cfg: TrainConfig, params, step: int = 0):
    """AdamW and its LambdaLR schedule, positioned at `step` (the learning
    rate of the next update is lr * factor(step))."""
    opt = torch.optim.AdamW(list(params), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    for group in opt.param_groups:
        group["initial_lr"] = cfg.learning_rate
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_factor(cfg),
                                                  last_epoch=step - 1)


def init_train_state(cfg: TrainConfig, net_config: nbvh.NbvhConfig,
                     device="cuda") -> TrainState:
    """Seeded weights (a CPU torch.Generator seeded with cfg.seed) made
    trainable, and a fresh optimizer."""
    net = nbvh.init_params(net_config,
                           torch.Generator().manual_seed(cfg.seed), device)
    net.requires_grad_(True)
    opt, sched = make_optimizer(cfg, net.parameters())
    return TrainState(net, opt, sched, 0)


def resolve_fused(cfg: TrainConfig, net_config: nbvh.NbvhConfig,
                  device) -> bool:
    """Whether the step differentiates through apply_train."""
    if cfg.fused_kernel not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused_kernel '{cfg.fused_kernel}'")
    if cfg.fused_kernel == "off" or net_config.grid_type != "lane":
        return False
    if cfg.fused_kernel == "on" and torch.device(device).type != "cuda":
        raise ValueError("fused_kernel='on' needs a CUDA device: the CUDA "
                         "kernels have no CPU mode (use 'auto' for their "
                         "twins)")
    return True


def loss_fn(net: nbvh.ShellNetwork, batch, fused: bool = True):
    """(total, components) of `shell_losses` on the network's outputs."""
    if fused:
        from ..ops.lane_grid_train_kernel import apply_train
        outputs = apply_train(net, batch.inputs)
    else:
        outputs = nbvh.mlp_forward(list(net.mlp),
                                   nbvh.encode_inputs(net, batch.inputs))
    return shell_losses(outputs, batch)


def make_train_step_on_batch(cfg: TrainConfig, net_config: nbvh.NbvhConfig,
                             device="cuda"):
    """(state, batch) -> (state, metrics): gradient and AdamW update on a
    batch supplied by the caller; `state` is updated in place. Metrics are
    device scalars (reading them synchronises)."""
    if cfg.compute_dtype != "bfloat16":
        raise ValueError("the port trains with bf16 MLP operands only "
                         f"(compute_dtype '{cfg.compute_dtype}')")
    fused = resolve_fused(cfg, net_config, device)

    def step(state: TrainState, batch):
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(state.net, batch, fused)
        total.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_train_step(cfg: TrainConfig, net_config: nbvh.NbvhConfig, gt_mesh,
                    outer, inner, outer_min, outer_inv_extent, radius: float,
                    global_row=None, device="cuda"):
    """(state, generator) -> (state, metrics) in two stages: sample a fresh
    segment batch on the device from the torch.Generator, then the gradient
    and update of make_train_step_on_batch. global_row: the scene's
    global-material row (scene_global_row)."""
    grad_step = make_train_step_on_batch(cfg, net_config, device)

    def step(state: TrainState, generator: torch.Generator):
        with torch.no_grad():
            batch = sample_segment_batch(
                generator, gt_mesh, outer, inner, outer_min,
                outer_inv_extent, cfg.batch_size, radius,
                segments_per_ray=cfg.segments_per_ray, global_row=global_row)
        return grad_step(state, batch)

    return step


# ---------------------------------------------------------------------------
# Checkpoints: weights .npz + Adam moments
# ---------------------------------------------------------------------------

def checkpoint_files(ckpt_dir: str, step: int):
    """(weights .npz, optimizer .npz) of a checkpoint. `<name>_ckpt` gives
    `<name>_step<N>.npz`, the file that render/renderer.py::
    npz_for_checkpoint maps `<name>_ckpt/step_<N>` to, so a config's
    checkpoint_path reaches it; the optimizer file stands beside it."""
    name = os.path.abspath(ckpt_dir)
    if name.endswith("_ckpt"):
        name = name[:-len("_ckpt")]
    weights = f"{name}_step{step}.npz"
    return weights, weights[:-len(".npz")] + ".adam.npz"


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """Write the weights and the Adam state; returns the weights path."""
    weights, adam = checkpoint_files(ckpt_dir, state.step)
    os.makedirs(os.path.dirname(weights), exist_ok=True)
    convert.save_params_npz(weights, state.net)
    arrays = {"step": np.int64(state.step)}
    names = ["lane"] + [f"mlp_{i}" for i in range(len(state.net.mlp))]
    for name, p in zip(names, state.net.parameters()):
        st = state.optimizer.state.get(p, {})
        for key in ("exp_avg", "exp_avg_sq"):
            arrays[f"{key}_{name}"] = (
                st[key].detach().cpu().numpy() if key in st
                else np.zeros(tuple(p.shape), np.float32))
    with open(adam, "wb") as f:
        np.savez(f, **arrays)
    return weights


def restore_checkpoint(path: str, cfg: TrainConfig,
                       net_config: nbvh.NbvhConfig,
                       device="cuda") -> TrainState:
    """A TrainState from save_checkpoint's files: `path` is the weights
    `.npz` or `<name>_ckpt/step_<N>`. Orbax checkpoints of the JAX package
    are refused: their weights can be exported, their optimizer state not."""
    from ..render.renderer import npz_for_checkpoint
    if os.path.isdir(path):
        raise ValueError(
            f"'{path}' is a directory (an orbax checkpoint of the JAX "
            "package?): this package reads its own checkpoints only. Export "
            "the weights with python scripts/export_lane_ckpt_npz.py "
            f"{path} <out.npz> to render them; resuming needs a checkpoint "
            "written by this trainer")
    weights = npz_for_checkpoint(path)
    adam = weights[:-len(".npz")] + ".adam.npz"
    if not os.path.exists(adam):
        raise ValueError(f"no optimizer state {adam} beside {weights}")
    net = convert.params_from_numpy(convert.load_params_npz(weights),
                                    net_config, device=device)
    net.requires_grad_(True)
    with np.load(adam) as z:
        step = int(z["step"])
        names = ["lane"] + [f"mlp_{i}" for i in range(len(net.mlp))]
        saved = {i: {"step": torch.tensor(float(step)),
                     "exp_avg": torch.as_tensor(z[f"exp_avg_{name}"]),
                     "exp_avg_sq": torch.as_tensor(z[f"exp_avg_sq_{name}"])}
                 for i, name in enumerate(names)}
    opt, sched = make_optimizer(cfg, net.parameters(), step)
    sd = opt.state_dict()
    sd["state"] = saved
    opt.load_state_dict(sd)
    return TrainState(net, opt, sched, step)


def export_reference_blob(path: str, state: TrainState,
                          net_config: nbvh.NbvhConfig):
    """The reference's flat FP16 blob encodes the tcnn grid layout, which
    this package does not have yet; lane-grid networks checkpoint as
    `.npz`."""
    raise NotImplementedError(
        "export_reference_blob: the tcnn-layout network and its flat FP16 "
        "blob are not ported; lane-grid networks are saved by "
        "save_checkpoint")
