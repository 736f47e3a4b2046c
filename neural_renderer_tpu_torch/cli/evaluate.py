"""evaluate CLI: ground truth against neural, with PSNR and FLIP.

Port of `neural_renderer_tpu/cli/evaluate.py`, same contract: render the
ground truth, then the neural frame, at total_samples (8 samples per batch
by default), save <output>/{ground_truth,neural,flip_error}.png, print PSNR
and mean/max FLIP. Runs on the GPU unless `--device cpu` is given.
A pass renders its batches in one loop that synchronises and reports
progress every `--chunk-batches` batches; `--host-loop`, or a sample count
that is not a multiple of `--batch-spp`, renders them one `render()` call
each instead, the last batch taking the rest. `--profile` prints the
per-stage timing table after each pass.

`--dp N` renders every pass in pixel stripes over N ranks, which the
command spawns itself (parallel/launch.py: one process per rank, rank r on
cuda:(r % device_count), NCCL when each rank has a GPU of its own, else
gloo; `--device cpu` runs them on the CPU over gloo). Rank 0 prints and
writes the images.

Usage: python -m neural_renderer_tpu_torch.cli.evaluate <config.json>
       [--width W --height H --output DIR --batch-spp N --total-samples N
        --ckpt FILE --no-additional --host-loop --chunk-batches N
        --profile --dp N --device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="GT vs neural comparison renderer")
    parser.add_argument("config")
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--output", default="comparison_output")
    parser.add_argument("--batch-spp", type=int, default=8)
    parser.add_argument("--total-samples", type=int, default=None,
                        help="override the config's total_samples")
    parser.add_argument("--ckpt", default="",
                        help="weights to load (an .npz, or the flat "
                             "FP16 blob of a tcnn-layout network), "
                             "overriding the config's checkpoint_path")
    parser.add_argument("--no-additional", action="store_true",
                        help="disable the additional mesh in the neural "
                             "pass (the ground-truth pass never traces it)")
    parser.add_argument("--host-loop", action="store_true",
                        help="one render() call per batch instead of the "
                             "accumulation loop (for A/B timing)")
    parser.add_argument("--chunk-batches", type=int, default=64,
                        help="batches between synchronisations and progress "
                             "updates")
    parser.add_argument("--profile", action="store_true",
                        help="print the per-stage timing table (ms and "
                             "ns/ray of the reference's categories) after "
                             "each pass; runs the stages again one by one")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel ranks: pixel stripes over N "
                             "processes (multi-GPU)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.dp < 1:
        print("evaluate: --dp (multi-GPU pixel stripes) must be at least 1",
              file=sys.stderr)
        return 1
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("evaluate: no CUDA device found; this program runs on the GPU "
              "(pass --device cpu for a small CPU run)", file=sys.stderr)
        return 1
    if args.dp > 1:
        from ..parallel.launch import describe, spawn
        print(f"evaluate: pixel stripes over {describe(args.dp, args.device)}",
              file=sys.stderr)
        return max(spawn(_rank_run, args.dp, args.device, args))
    return run(args, torch.device(args.device))


def _rank_run(rank, world, device, args) -> int:
    from ..parallel import make_mesh
    return run(args, device, make_mesh(dp=world, tp=1))


def run(args, device, mesh=None) -> int:
    """The comparison on `device`; with a mesh, this rank's share of
    pixel-stripe rendering (rank 0 prints, writes and scores)."""
    import torch
    on_gpu = device.type == "cuda"
    lead = mesh is None or mesh.get_rank() == 0

    print("=== Comparison Renderer ===")

    from ..config import (camera_basis_from_state, load_config,
                          matrix_to_camera_state)
    from ..metrics import compute_flip, compute_psnr, save_png
    from ..render.renderer import RenderBasis, Renderer
    from ..scene.scene import Scene
    from ..utils.progress import ProgressBar

    cfg = load_config(args.config)
    total_samples = args.total_samples or cfg.rendering.total_samples
    if args.batch_spp < 1 or total_samples < 1:
        print("evaluate: --batch-spp and the total sample count must be "
              "positive", file=sys.stderr)
        return 1
    if lead:
        os.makedirs(args.output, exist_ok=True)

    # Camera: the position is scaled by the original mesh's scale.
    pos, yaw, pitch = matrix_to_camera_state(cfg.camera.matrix)
    pos = pos * cfg.original_mesh.scale
    print(f"Loaded camera: pos=({pos[0]:.2f}, {pos[1]:.2f}, {pos[2]:.2f}), "
          f"yaw={yaw:.2f}, pitch={pitch:.2f}, fovY={cfg.camera.yfov:.2f}")

    scene = Scene.from_config(cfg)
    print(f"Loaded original mesh: {scene.original_mesh.num_triangles} "
          "triangles")
    print(f"Loaded inner shell: {scene.inner_shell.num_triangles} triangles")
    print(f"Loaded outer shell: {scene.outer_shell.num_triangles} triangles")
    # Without its meshes the comparison would be of something else.
    failed = [m for m in scene.failed_meshes
              if not (args.no_additional and m == "additional mesh")]
    if failed:
        print("evaluate: could not load: " + ", ".join(failed),
              file=sys.stderr)
        return 1
    if scene.environment_error is not None:
        print("evaluate: could not load the environment map: "
              + scene.environment_error, file=sys.stderr)
        return 1
    if scene.original_mesh.num_triangles == 0 \
            or scene.outer_shell.num_triangles == 0:
        print("evaluate: the config must name an original mesh and an outer "
              "shell", file=sys.stderr)
        return 1

    renderer = Renderer(scene, cfg.neural_network, device=device)
    renderer.set_device_mesh(mesh)
    renderer.set_constant_neural_color(cfg.material.use_constant_neural_color,
                                       cfg.material.constant_neural_color)
    if args.no_additional:
        renderer.set_use_additional_mesh(False)
    renderer.resize(args.width, args.height)
    renderer.set_bounce_count(cfg.rendering.bounce_count)
    renderer.set_lambert_view(False)
    renderer.set_envmap_rotation(cfg.environment.rotation)

    ckpt = args.ckpt or cfg.checkpoint_path
    if ckpt:
        if renderer.load_weights_from_file(ckpt):
            print(f"Loaded checkpoint: {ckpt}")
        else:
            print(f"Failed to load checkpoint: {ckpt}", file=sys.stderr)
            return 1

    fwd, right, up, fov = camera_basis_from_state(yaw, pitch, cfg.camera.yfov)
    renderer.set_camera_basis(RenderBasis(fwd, right, up, fov))

    def render_pass(label: str, neural: bool) -> np.ndarray:
        print(f"\n=== Rendering {label} ({total_samples} samples) ===")
        renderer.set_use_neural_query(neural)
        renderer.reset_samples()
        if on_gpu:
            torch.cuda.reset_peak_memory_stats(device)
        bar = ProgressBar()
        if args.host_loop or total_samples % args.batch_spp != 0:
            # One render() per batch, the last one taking the rest.
            bar.begin(label, -(-total_samples // args.batch_spp))
            remaining, it = total_samples, 0
            if on_gpu:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            while remaining > 0:
                batch = min(remaining, args.batch_spp)
                renderer.set_samples_per_pixel(batch)
                img = renderer.render(pos)
                remaining -= batch
                it += 1
                bar.update(it)
            renderer.last_frame_seconds = time.perf_counter() - t0
            renderer.last_frame_rays = args.width * args.height * \
                total_samples
        else:
            bar.begin(label, total_samples // args.batch_spp)
            img = renderer.render_accumulate(
                pos, total_samples, batch_spp=args.batch_spp,
                chunk_batches=args.chunk_batches,
                progress=lambda done, total: bar.update(done))
        print(f"{label}: {renderer.mrays_per_second:.2f} Mrays/s "
              f"({renderer.last_frame_seconds:.3f} s)")
        if on_gpu:
            print(f"{label}: peak device memory "
                  f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} "
                  "MiB")
        return img

    def profile_pass(neural: bool):
        if args.profile:
            from ..render.profiler import profile_renderer
            print(profile_renderer(renderer, pos, neural).table())

    gt = render_pass("Ground truth", neural=False)
    profile_pass(neural=False)
    neural = render_pass("Neural", neural=True)
    profile_pass(neural=True)
    if not lead:
        return 0
    save_png(os.path.join(args.output, "ground_truth.png"), gt)
    save_png(os.path.join(args.output, "neural.png"), neural)

    psnr = compute_psnr(gt, neural)
    print("\n=== Metrics ===")
    print(f"PSNR: {psnr:.2f} dB")
    print("Computing FLIP error...")
    mean_err, max_err = compute_flip(
        gt, neural, output_path=os.path.join(args.output, "flip_error.png"),
        device=device)
    print(f"FLIP max error: {max_err:.4f}")
    print(f"FLIP: {mean_err:.4f} (mean)")
    print("\nComparison complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
