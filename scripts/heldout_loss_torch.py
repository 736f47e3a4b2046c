"""Held-out training loss of lane-grid weight files on the same segments.

Draws `--batches` batches of `--batch` segments with the port's sampler
(train/dataset.py, a torch.Generator seeded with `--seed`) from a scene
config, and prints for each weight file the mean of every loss component
(train/losses.py) of the training forward on those batches. Every file
sees the same segments, so the numbers compare networks, e.g. two seeds of
one recipe or a port-trained file against a JAX-trained export.

Usage: python scripts/heldout_loss_torch.py CONFIG WEIGHTS [WEIGHTS ...]
         [--batches N --batch N --segments-per-ray S --seed N
          --device cuda|cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("weights", nargs="+")
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--segments-per-ray", type=int, default=1)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    from neural_renderer_tpu_torch import train
    from neural_renderer_tpu_torch.config import load_config
    from neural_renderer_tpu_torch.ops import lane_grid_kernel
    from neural_renderer_tpu_torch.render.renderer import Renderer
    from neural_renderer_tpu_torch.scene.scene import Scene

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("heldout_loss_torch: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    cfg = load_config(args.config)
    scene = Scene.from_config(cfg)
    meshes = [m.to_tensors(dev) for m in (scene.original_mesh,
                                          scene.outer_shell,
                                          scene.inner_shell)]
    omin, inv, radius = train.segment_domain(scene, dev)
    row = train.scene_global_row(scene, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.no_grad():
        batches = [train.sample_segment_batch(
            gen, *meshes, omin, inv, args.batch, radius,
            args.segments_per_ray, global_row=row)
            for _ in range(args.batches)]
    for path in args.weights:
        renderer = Renderer(scene, cfg.neural_network, device=dev)
        if not renderer.load_weights_from_file(path):
            print(f"heldout_loss_torch: cannot load {path}", file=sys.stderr)
            return 1
        sums = {}
        for b in batches:
            with torch.no_grad():
                total, parts = train.shell_losses(
                    lane_grid_kernel.forward_train(renderer.net, b.inputs),
                    b)
            for k, v in {"total": total, **parts}.items():
                sums.setdefault(k, []).append(float(v))
        print(path + ": " + ", ".join(f"{k} {np.mean(v):.5f}"
                                      for k, v in sums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
