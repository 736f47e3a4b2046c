"""Time and hold the lane-grid kernels (K2, K6) of one checkout of the port.

    python scripts/compare_lane_grid_kernels.py [TREE]

Imports neural_renderer_tpu_torch from TREE (default: this checkout), so
two versions compare on one card by running it on each in turns (A, B, B,
A). Prints one JSON line: the card, K2's and K6's device ms per launch
(CUDA events, best of 3 x 20 or 3 x 5 launches) on 131,072 random rays of
a seeded S=16, entry_pack 2 network (tables x 1e3) under a random
cotangent, and K6's largest |kernel - twin| / max|twin| over its six
gradients in the cases of tests/test_torch_cuda.py that hold it to 1e-3:
5,000 random rays under a random cotangent (test_train_kernels_match_twins)
and segments sampled from small shells under the training loss
(test_train_kernels_counts: 31 at S=16, pack 2; 131,072 at S=16, pack 2
and at S=4, pack 1). Needs a CUDA device; no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("compare_lane_grid_kernels: needs a CUDA device",
              file=sys.stderr)
        return 2
    from neural_renderer_tpu_torch.models import nbvh
    from neural_renderer_tpu_torch.ops import lane_grid_kernel as lgk
    from neural_renderer_tpu_torch.ops import lane_grid_train_kernel as ltk
    from neural_renderer_tpu_torch.scene.mesh import outward_sphere
    from neural_renderer_tpu_torch.scene.scene import Scene
    from neural_renderer_tpu_torch.train import (sample_segment_batch,
                                                 segment_domain,
                                                 shell_losses)
    dev = torch.device("cuda")

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(3):
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / reps)
        return best

    def seeded(sublanes, entry_pack):
        net = nbvh.init_params(nbvh.NbvhConfig(lane_sublanes=sublanes,
                                               lane_entry_pack=entry_pack),
                               torch.Generator().manual_seed(0), dev)
        with torch.no_grad():
            net.lane.mul_(1e3)
        return net

    def worst(net, x, cot):
        got = ltk.backward_lane(net, x, cot)
        ref = ltk.backward_twin(net, x, cot)
        return max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip([got[0], *got[1]], [ref[0], *ref[1]]))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"tree": tree, "card": smi}
    net = seeded(16, 2)
    x = torch.rand((12, 131072),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    cot = torch.randn((16, 131072),
                      generator=torch.Generator().manual_seed(2)).to(dev)
    out["K2_ms"] = time_ms(lambda: lgk.forward_lane(net, x), 20)
    out["K6_ms"] = time_ms(lambda: ltk.backward_lane(net, x, cot), 5)
    gen = torch.Generator().manual_seed(4)
    x5 = torch.rand((12, 5000), generator=gen).to(dev)
    c5 = torch.randn((16, 5000), generator=gen).to(dev)
    out["K6_rel_random_5000"] = worst(net, x5, c5)
    scene = Scene(original_mesh=outward_sphere(16, 32, 1.0),
                  inner_shell=outward_sphere(16, 32, 0.8),
                  outer_shell=outward_sphere(16, 32, 1.2))
    meshes = [getattr(scene, m).to_tensors(dev) for m in
              ("original_mesh", "outer_shell", "inner_shell")]
    omin, inv, radius = segment_domain(scene, dev)
    for sublanes, entry_pack, n in ((16, 2, 31), (16, 2, 131072),
                                    (4, 1, 131072)):
        gen = torch.Generator(device=dev).manual_seed(n)
        with torch.no_grad():
            batch = sample_segment_batch(gen, *meshes, omin, inv, n, radius,
                                         2)
        xb = batch.inputs.contiguous()
        nb = seeded(sublanes, entry_pack)
        o = lgk.forward_train(nb, xb).detach().requires_grad_(True)
        (cb,) = torch.autograd.grad(shell_losses(o, batch)[0], o)
        out[f"K6_rel_loss_S{sublanes}_pack{entry_pack}_n{n}"] = worst(
            nb, xb, cb)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
