"""train CLI: online training of the shell network for a scene config.

Port of `neural_renderer_tpu/cli/train.py`, same flags and log line. Samples
shell segments against the ground-truth mesh on the device, optimizes with
AdamW, and writes checkpoints as `<name>_step<N>.npz` (the weights, which
`evaluate --ckpt` and a config's `checkpoint_path` of `<name>_ckpt/step_<N>`
load) plus `<name>_step<N>.adam.npz` (the optimizer state, for `--resume`).
Without `--ckpt-dir` the name is `<config>` (beside the config file). A
tcnn-layout network is also exported as the reference's flat FP16 blob,
`--out` (default `<config>_weights.bin`). Runs on the GPU unless `--device
cpu` is given.

`--dp D --tp T` trains on D x T ranks that the command spawns
(parallel/launch.py; `--device cpu` runs them on the CPU over gloo): the
batch's rows are split over the ranks, each rank holds 1/T of the network
and of its AdamW moments, and a step equals the single-process step up to
the order of the f32 sums (parallel/shardings.py). Rank 0 prints and writes
the checkpoint. An orbax checkpoint of the JAX package resumes through its
export (scripts/export_lane_ckpt_npz.py writes the `.npz` and `.adam.npz`).

Usage: python -m neural_renderer_tpu_torch.cli.train <config.json>
         [--steps N --batch-size B --lr LR --ckpt-dir DIR --resume CKPT
          --out BLOB
          --lr-schedule constant|cosine --segments-per-ray S
          --fused auto|on|off --dp D --tp T --device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Shell-network trainer")
    parser.add_argument("config")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=16384)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--out", default="",
                        help="flat FP16 blob output path of a "
                             "tcnn-layout network (default "
                             "<config>_weights.bin)")
    parser.add_argument("--ckpt-dir", default="",
                        help="checkpoint name <name>_ckpt: writes "
                             "<name>_step<N>.npz and .adam.npz")
    parser.add_argument("--resume", default="",
                        help="checkpoint to resume (<name>_step<N>.npz or "
                             "<name>_ckpt/step_<N>)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lr-schedule", default="constant",
                        choices=["constant", "cosine"])
    parser.add_argument("--segments-per-ray", type=int, default=1,
                        help="march sampled rays N segments deep and train "
                             "on all of them (needed for non-convex shells, "
                             "e.g. configs/knot)")
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel ranks (the batch's rows split)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ranks (network and moments "
                             "sharded)")
    parser.add_argument("--fused", default="auto",
                        choices=("auto", "on", "off"),
                        help="lane-grid gradient path: 'auto' the CUDA "
                             "kernels (their twins on the CPU), 'on' the "
                             "kernels only, 'off' autograd through the "
                             "plain PyTorch forward")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dp < 1 or args.tp < 1:
        print("train: --dp and --tp (multi-GPU ranks) must be at least 1",
              file=sys.stderr)
        return 1
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("train: no CUDA device found; this program runs on the GPU "
              "(pass --device cpu for a small CPU run)", file=sys.stderr)
        return 1
    world = args.dp * args.tp
    if world > 1:
        from ..parallel.launch import describe, spawn
        print(f"train: dp={args.dp} x tp={args.tp}, "
              f"{describe(world, args.device)}", file=sys.stderr)
        return max(spawn(_rank_run, world, args.device, args))
    return run(args, torch.device(args.device))


def _rank_run(rank, world, device, args) -> int:
    from ..parallel import make_mesh
    return run(args, device, make_mesh(dp=args.dp, tp=args.tp))


def run(args, dev, mesh=None) -> int:
    """Training on `dev`; with a mesh, this rank's share of it."""
    import torch
    on_gpu = dev.type == "cuda"

    from ..config import load_config
    from ..models import nbvh
    from ..scene.scene import Scene
    from ..train import (TrainConfig, export_reference_blob,
                         init_train_state, make_train_step,
                         restore_checkpoint, save_checkpoint,
                         scene_global_row, segment_domain)

    cfg = load_config(args.config)
    nn_cfg = cfg.neural_network
    scene = Scene.from_config(cfg)
    if scene.failed_meshes:
        print("train: could not load: " + ", ".join(scene.failed_meshes),
              file=sys.stderr)
        return 1
    if scene.outer_shell.num_triangles == 0 or \
            scene.original_mesh.num_triangles == 0:
        print("config must provide original mesh and outer shell",
              file=sys.stderr)
        return 1

    net_config = nbvh.NbvhConfig.from_network_config(nn_cfg)
    tcfg = TrainConfig(batch_size=args.batch_size, learning_rate=args.lr,
                       steps=args.steps, seed=args.seed,
                       log_every=args.log_every,
                       lr_schedule=args.lr_schedule,
                       segments_per_ray=args.segments_per_ray,
                       fused_kernel=args.fused)

    gt = scene.original_mesh.to_tensors(dev)
    outer = scene.outer_shell.to_tensors(dev)
    inner = scene.inner_shell.to_tensors(dev)
    omin, inv_extent, radius = segment_domain(scene, dev)

    try:
        state = (restore_checkpoint(args.resume, tcfg, net_config, dev)
                 if args.resume else init_train_state(tcfg, net_config, dev))
        step_fn = make_train_step(tcfg, net_config, gt, outer, inner, omin,
                                  inv_extent, radius,
                                  global_row=scene_global_row(scene, dev),
                                  device=dev, mesh=mesh)
    except (OSError, ValueError) as e:
        if mesh is not None:
            raise
        print(f"train: {e}", file=sys.stderr)
        return 1
    unsharded = sum(p.numel() * p.element_size()
                    for p in state.net.parameters())
    if mesh is not None:
        from ..parallel import shard_train_state
        state = shard_train_state(state, mesh)
        print(f"Device mesh: dp={args.dp} tp={args.tp}")
    print(f"Training on {torch.cuda.get_device_name(dev) if on_gpu else 'cpu'}"
          f" from step {state.step}")

    generator = torch.Generator(device=dev).manual_seed(args.seed + 1)
    ckpt_dir = args.ckpt_dir or (os.path.splitext(args.config)[0] + "_ckpt")
    t0 = time.monotonic()
    start_step = state.step
    for i in range(start_step, args.steps):
        state, metrics = step_fn(state, generator)
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            m = {k: float(v) for k, v in metrics.items()}
            if on_gpu:
                torch.cuda.synchronize(dev)
            rate = (i + 1 - start_step) * tcfg.batch_size / (
                time.monotonic() - t0)
            print(f"step {i+1}/{args.steps} loss={m['total']:.4f} "
                  f"presence={m['presence']:.4f} dist={m['distance']:.4f} "
                  f"normal={m['normal']:.4f} color={m['color']:.4f} "
                  f"({rate/1e6:.2f} Msegments/s)", flush=True)
        if args.ckpt_dir and (i + 1) % tcfg.checkpoint_every == 0:
            print(f"checkpoint: {save_checkpoint(args.ckpt_dir, state)}")

    if mesh is not None:
        report_shard_bytes(state, unsharded)
    print(f"final checkpoint: {save_checkpoint(ckpt_dir, state)}")
    if net_config.grid_type == "tcnn":
        if mesh is not None:
            state = dataclasses.replace(state, net=state.net.gather())
            if mesh.get_rank() != 0:
                return 0
        out = args.out or (os.path.splitext(args.config)[0] + "_weights.bin")
        export_reference_blob(out, state, net_config)
        print(f"exported flat FP16 blob: {out}")
    return 0


def report_shard_bytes(state, unsharded: int):
    """Print every rank's network + AdamW moment bytes beside the
    unsharded network's and moments' (three times the network)."""
    import torch
    from ..parallel.shardings import all_gather_cat, state_bytes
    b = state_bytes(state)
    mine = torch.tensor([[b["network_bytes"], b["moment_bytes"]]],
                        dtype=torch.int64, device=state.net.device)
    every = all_gather_cat(mine, None, 0).tolist()
    print("rank network + moment bytes: "
          + ", ".join(f"{n} + {m}" for n, m in every)
          + f" (unsharded {unsharded} + {2 * unsharded})")


if __name__ == "__main__":
    sys.exit(main())
