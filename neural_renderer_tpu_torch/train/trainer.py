"""Online training loop: AdamW, cosine schedule, `.npz` checkpoints.

Port of `neural_renderer_tpu/train/trainer.py`. Each step samples a fresh
segment batch against the ground-truth mesh on the device, then takes the
gradient of `shell_losses` and an AdamW update. On lane-grid networks the
gradient comes from `ops/lane_grid_train_kernel.py::apply_train` (K2 in
training layout forward, K6 backward); `fused_kernel="off"` differentiates
the plain PyTorch forward instead. tcnn-layout networks always take autograd
through the hash-grid encode and `nbvh.mlp_forward`, the path the JAX
trainer differentiates (the fused MLP kernel K7 is inference-only).

The optimizer has optax.adamw's semantics (b1 0.9, b2 0.999, eps 1e-8 added
outside the square root, decoupled weight decay on every parameter, the
learning rate of step t taken before the step count advances), and the
cosine schedule is optax.cosine_decay_schedule's. Checkpoints are this
package's own: the weights `.npz` of models/convert.py plus a file with the
Adam moments and the step; `export_reference_blob` writes a tcnn-layout
network as the reference's flat FP16 blob. The JAX package's orbax
checkpoints resume through the same two files, which
scripts/export_lane_ckpt_npz.py writes from them (optax's mu, nu and count
are AdamW's exp_avg, exp_avg_sq and step).

With a (dp, tp) mesh (parallel/shardings.py) the state holds this rank's
shards (`shard_train_state`) and a step runs on this rank's rows of the
batch: the loss divides by the counts of the whole batch, and the
gradients are reduced over the ranks before each rank updates its shard.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..models import convert, nbvh
from ..utils import spans
from .dataset import sample_segment_batch
from .losses import loss_counts, shell_losses


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
    """Whether the step differentiates through apply_train (lane-grid
    networks only)."""
    if cfg.fused_kernel not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused_kernel '{cfg.fused_kernel}'")
    if cfg.fused_kernel == "off" or net_config.grid_type != "lane":
        return False
    if cfg.fused_kernel == "on" and torch.device(device).type != "cuda":
        raise ValueError("fused_kernel='on' needs a CUDA device: the CUDA "
                         "kernels have no CPU mode (use 'auto' for their "
                         "twins)")
    return True


def loss_fn(net: nbvh.ShellNetwork, batch, fused: bool = True,
            counts=None):
    """(total, components) of `shell_losses` on the network's outputs;
    `counts` as shell_losses takes them."""
    if fused:
        from ..ops.lane_grid_train_kernel import apply_train
        outputs = apply_train(net, batch.inputs)
    else:
        outputs = nbvh.mlp_forward(list(net.mlp),
                                   nbvh.encode_inputs(net, batch.inputs))
    return shell_losses(outputs, batch, counts=counts)


# The batch axis of a meshed step: rows split over every rank.
BATCH_AXES = ("dp", "tp")


def _sharded_grad_step(state: TrainState, batch, fused: bool):
    """Gradient and update of a sharded state on this rank's rows: the
    whole network gathered for the forward and backward, the loss over the
    whole batch's counts, the gradients reduced into the shards; the
    metrics summed over the ranks are the whole batch's losses."""
    from ..parallel.shardings import all_reduce_sum
    sharded = state.net
    with spans.span("lossGrad"):
        full = sharded.gather()
        counts = all_reduce_sum(torch.stack(loss_counts(batch)))
        total, metrics = loss_fn(full, batch, fused, counts=(counts[0],
                                                              counts[1]))
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        sharded.reduce_grads(full)
    with spans.span("optimizerStep"):
        state.optimizer.step()
        state.scheduler.step()
    state.step += 1
    names = list(metrics)
    summed = all_reduce_sum(torch.stack([metrics[k].detach()
                                         for k in names]))
    return state, dict(zip(names, summed))


def _local_grad_step(cfg: TrainConfig, net_config: nbvh.NbvhConfig, device,
                     sharded: bool):
    """(state, batch of this rank's rows) -> (state, metrics)."""
    if cfg.compute_dtype != "bfloat16":
        raise ValueError("the port trains with bf16 MLP operands only "
                         f"(compute_dtype '{cfg.compute_dtype}')")
    fused = resolve_fused(cfg, net_config, device)
    if sharded:
        return lambda state, batch: _sharded_grad_step(state, batch, fused)

    def step(state: TrainState, batch):
        with spans.span("lossGrad"):
            state.optimizer.zero_grad(set_to_none=True)
            total, metrics = loss_fn(state.net, batch, fused)
            total.backward()
        with spans.span("optimizerStep"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_train_step_on_batch(cfg: TrainConfig, net_config: nbvh.NbvhConfig,
                             device="cuda", mesh=None):
    """(state, batch) -> (state, metrics): gradient and AdamW update on a
    batch supplied by the caller; `state` is updated in place. Metrics are
    device scalars (reading them synchronises). With a mesh, `state` comes
    from parallel.shard_train_state and every rank passes the whole batch,
    of which it takes its rows (constrain_batch_dp)."""
    step = _local_grad_step(cfg, net_config, device, mesh is not None)
    if mesh is None:
        return step
    from ..parallel.shardings import constrain_batch_dp
    return lambda state, batch: step(
        state, constrain_batch_dp(batch, mesh, BATCH_AXES))


def make_train_step(cfg: TrainConfig, net_config: nbvh.NbvhConfig, gt_mesh,
                    outer, inner, outer_min, outer_inv_extent, radius: float,
                    global_row=None, device="cuda", mesh=None):
    """(state, generator) -> (state, metrics) in two stages: sample a fresh
    segment batch on the device from the torch.Generator, then the gradient
    and update of make_train_step_on_batch. global_row: the scene's
    global-material row (scene_global_row). With a mesh every rank draws
    the same rays from its generator (seeded alike) and marches only its
    share of them (sample_segment_batch's `shard`). Traced as the span
    `trainStep` around the stages `sampleSegments`, `lossGrad` and
    `optimizerStep` (utils/spans.py)."""
    grad_step = _local_grad_step(cfg, net_config, device, mesh is not None)
    shard = None
    if mesh is not None:
        from ..parallel.shardings import axis_coords
        shard = axis_coords(mesh, BATCH_AXES)

    def step(state: TrainState, generator: torch.Generator):
        with spans.span("trainStep"):
            with torch.no_grad(), spans.span("sampleSegments"):
                batch = sample_segment_batch(
                    generator, gt_mesh, outer, inner, outer_min,
                    outer_inv_extent, cfg.batch_size, radius,
                    segments_per_ray=cfg.segments_per_ray,
                    global_row=global_row, shard=shard)
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


def _moments(state: TrainState, key: str) -> list:
    """The optimizer's `key` moment of each parameter (zeros before the
    first step), whole tensors also for a sharded state."""
    params = list(state.net.parameters())
    out = [state.optimizer.state.get(p, {}).get(key) for p in params]
    out = [torch.zeros_like(p.detach()) if m is None else m.detach()
           for p, m in zip(params, out)]
    if hasattr(state.net, "gather_tensors"):
        out = state.net.gather_tensors(out)
    return out


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """Write the weights and the Adam state; returns the weights path. A
    sharded state is gathered on every rank (call it on all of them) and
    written by rank 0."""
    import torch.distributed as dist
    weights, adam = checkpoint_files(ckpt_dir, state.step)
    net = state.net.gather() if hasattr(state.net, "gather") else state.net
    moments = {key: _moments(state, key) for key in ("exp_avg",
                                                     "exp_avg_sq")}
    if dist.is_initialized() and dist.get_rank() != 0:
        return weights
    os.makedirs(os.path.dirname(weights), exist_ok=True)
    convert.save_params_npz(weights, net)
    arrays = {"step": np.int64(state.step)}
    for i, name in enumerate(convert.param_names(net)):
        for key, ms in moments.items():
            arrays[f"{key}_{name}"] = ms[i].cpu().numpy()
    with open(adam, "wb") as f:
        np.savez(f, **arrays)
    return weights


def restore_checkpoint(path: str, cfg: TrainConfig,
                       net_config: nbvh.NbvhConfig,
                       device="cuda") -> TrainState:
    """A TrainState from save_checkpoint's files: `path` is the weights
    `.npz` or `<name>_ckpt/step_<N>`. An orbax checkpoint of the JAX
    package resumes through the two files scripts/export_lane_ckpt_npz.py
    writes from it; the directory itself is refused (this package does not
    read orbax)."""
    from ..render.renderer import npz_for_checkpoint
    if os.path.isdir(path):
        raise ValueError(
            f"'{path}' is a directory (an orbax checkpoint of the JAX "
            "package?); this package does not read orbax. Export it with "
            f"python scripts/export_lane_ckpt_npz.py {path} <out.npz> "
            "<config.json>, which writes the weights <out.npz> and the "
            "optimizer state <out>.adam.npz, then resume from <out.npz>")
    weights = npz_for_checkpoint(path)
    adam = weights[:-len(".npz")] + ".adam.npz"
    if not os.path.exists(adam):
        raise ValueError(f"no optimizer state {adam} beside {weights}")
    net = convert.params_from_numpy(convert.load_params_npz(weights),
                                    net_config, device=device)
    net.requires_grad_(True)
    with np.load(adam) as z:
        step = int(z["step"])
        names = convert.param_names(net)
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
    """Write the reference-compatible flat FP16 checkpoint ([hg | mlp], the
    shared grid) of a tcnn-layout network."""
    nbvh.save_flat_blob(path, state.net)
