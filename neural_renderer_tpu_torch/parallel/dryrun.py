"""Multi-rank dry run: the port's counterpart of `dryrun_multichip` in the
JAX package's `__graft_entry__.py`.

    python -m neural_renderer_tpu_torch.parallel.dryrun [N] [--device cpu|cuda]

Spawns N ranks (parallel/launch.py; gloo on the CPU) over a (dp, tp) mesh,
tp = 2 when N is even, and on each of them runs one dp x tp training step
of a tiny lane network (sharded state, the batch's rows split over the
ranks), then the ground-truth and neural pixel-stripe renders of a UV
sphere (rows over "dp"). Prints one line starting `dryrun_multichip OK`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

# The tiny network (the JAX dry run's widths, as a lane grid): the trainer
# differentiates its plain forward, since K6 takes 4 x 128 MLPs only.
TINY = dict(grid_type="lane", lane_sublanes=2, log2_hashmap_size=6,
            base_resolution=4, n_levels=2, mlp_width=32, mlp_hidden_layers=2)


def tiny_batch(config, b: int, seed: int = 0, device="cpu"):
    """A seeded SegmentBatch of b rows for `config`'s network."""
    from ..train import SegmentBatch
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return SegmentBatch(
        inputs=t(rng.uniform(size=(config.input_dims, b))),
        presence=t(rng.integers(0, 2, b)),
        distance=t(rng.uniform(size=b)),
        normal=t(rng.normal(size=(3, b))),
        color=t(rng.uniform(size=(3, b))),
        valid=t(np.ones(b, bool), torch.bool))


def _rank(rank, world, dev):
    from ..models import nbvh
    from ..render.neural_march import NeuralContext
    from ..render.params import RenderParams
    from ..scene.envmap import EnvironmentTensors
    from ..scene.materials import Material
    from ..scene.mesh import outward_sphere
    from ..train import TrainConfig, init_train_state
    from ..train.trainer import make_train_step_on_batch
    from .shardings import (make_mesh, render_gt_frame_tiled,
                            render_neural_frame_tiled, shard_train_state)

    tp = 2 if world % 2 == 0 else 1
    dp = world // tp
    mesh = make_mesh(dp, tp)
    config = nbvh.NbvhConfig(**TINY)
    cfg = TrainConfig(batch_size=world * 16, fused_kernel="off")
    state = shard_train_state(init_train_state(cfg, config, dev), mesh)
    step = make_train_step_on_batch(cfg, config, dev, mesh)
    state, metrics = step(state, tiny_batch(config, cfg.batch_size,
                                            device=dev))
    loss = float(metrics["total"])
    assert np.isfinite(loss)

    outer_h = outward_sphere(6, 12, 1.0)
    outer = outer_h.to_tensors(dev)
    inner = outward_sphere(5, 10, 0.7).to_tensors(dev)
    env = EnvironmentTensors.from_numpy(None, device=dev)
    h, w = dp * 4, 16
    omin, omax = outer_h.bounds()
    params = RenderParams.make(
        w, h, 1, 1, cam_pos=[0, 0, 3.0], cam_forward=[0, 0, -1.0],
        cam_right=[1, 0, 0.0], cam_up=[0, 1, 0.0], fov_y=1.0,
        material=Material.default(), scene_scale=2.0,
        outer_shell_min=omin, outer_shell_inv_extent=1.0 / (omax - omin),
        device=dev)
    # Each rank's accumulation is its stripe of 4 rows.
    img, _ = render_gt_frame_tiled(outer, env, params,
                                   torch.zeros((3, 4 * w), device=dev), mesh)
    assert tuple(img.shape) == (h, w, 3)
    net = nbvh.init_params(nbvh.NbvhConfig(
        grid_type="lane", lane_sublanes=2, n_levels=2, mlp_width=32,
        mlp_hidden_layers=2), torch.Generator().manual_seed(1), dev)
    nimg, _ = render_neural_frame_tiled(
        NeuralContext(outer, inner, net), env, params,
        torch.zeros((3, 4 * w), device=dev), mesh)
    assert tuple(nimg.shape) == (h, w, 3)
    return dict(dp=dp, tp=tp, loss=loss, gt=tuple(img.shape),
                neural=tuple(nimg.shape))


def dryrun_multichip(n_devices: int, device="cpu",
                     join_timeout: float = 120.0) -> dict:
    """Run the dry run on n_devices ranks; returns rank 0's summary."""
    from .launch import spawn
    out = spawn(_rank, n_devices, device, join_timeout=join_timeout)[0]
    print(f"dryrun_multichip OK: mesh dp={out['dp']} tp={out['tp']}, train "
          f"loss={out['loss']:.4f}, gt image {out['gt']}, neural image "
          f"{out['neural']}")
    return out


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, nargs="?", default=4)
    parser.add_argument("--device", default="cpu")
    a = parser.parse_args()
    dryrun_multichip(a.n, a.device)
    sys.exit(0)
