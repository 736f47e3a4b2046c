"""evaluate CLI: ground truth against neural, with PSNR and FLIP.

Port of `neural_renderer_tpu/cli/evaluate.py`, same contract: render the
ground truth, then the neural frame, at total_samples (8 samples per batch
by default), save <output>/{ground_truth,neural,flip_error}.png, print PSNR
and mean/max FLIP. Runs on the GPU unless `--device cpu` is given.

Usage: python -m neural_renderer_tpu_torch.cli.evaluate <config.json>
       [--width W --height H --output DIR --batch-spp N --total-samples N
        --ckpt FILE --no-additional --device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

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
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("evaluate: no CUDA device found; this program runs on the GPU "
              "(pass --device cpu for a small CPU run)", file=sys.stderr)
        return 1
    on_gpu = args.device.startswith("cuda")

    print("=== Comparison Renderer ===")

    from ..config import (camera_basis_from_state, load_config,
                          matrix_to_camera_state)
    from ..metrics import compute_flip, compute_psnr, save_png
    from ..render.renderer import RenderBasis, Renderer
    from ..scene.scene import Scene
    from ..utils.progress import ProgressBar

    cfg = load_config(args.config)
    total_samples = args.total_samples or cfg.rendering.total_samples
    if total_samples % args.batch_spp != 0:
        print(f"evaluate: total samples {total_samples} must be a multiple "
              f"of --batch-spp {args.batch_spp}", file=sys.stderr)
        return 1
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

    renderer = Renderer(scene, cfg.neural_network, device=args.device)
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
            torch.cuda.reset_peak_memory_stats()
        bar = ProgressBar()
        bar.begin(label, total_samples // args.batch_spp)
        img = renderer.render_accumulate(
            pos, total_samples, batch_spp=args.batch_spp,
            progress=lambda done, total: bar.update(done))
        print(f"{label}: {renderer.mrays_per_second:.2f} Mrays/s "
              f"({renderer.last_frame_seconds:.3f} s)")
        if on_gpu:
            print(f"{label}: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        return img

    gt = render_pass("Ground truth", neural=False)
    save_png(os.path.join(args.output, "ground_truth.png"), gt)
    neural = render_pass("Neural", neural=True)
    save_png(os.path.join(args.output, "neural.png"), neural)

    psnr = compute_psnr(gt, neural)
    print("\n=== Metrics ===")
    print(f"PSNR: {psnr:.2f} dB")
    print("Computing FLIP error...")
    mean_err, max_err = compute_flip(
        gt, neural, output_path=os.path.join(args.output, "flip_error.png"),
        device=args.device)
    print(f"FLIP max error: {max_err:.4f}")
    print(f"FLIP: {mean_err:.4f} (mean)")
    print("\nComparison complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
