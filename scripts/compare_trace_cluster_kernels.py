"""Time and hold the clustered closest-hit kernels (K5, K5-MXU) of one
checkout of the port.

    python scripts/compare_trace_cluster_kernels.py [TREE]

Imports neural_renderer_tpu_torch from TREE (default: this checkout), so
two versions compare on one card by running it on each in turns (A, B, B,
A). Builds `chip_smoke.py` phase 5's two cases from the knot scene
(configs/knot/knot_lane.json, 65,536 triangles in 256 clusters): 131,072
of the 1080p camera rays (FORWARD_ONLY) and 131,072 first-bounce rays
(ANY), each sorted as the GT path sorts them and cut around the middle of
the rays that meet the mesh's box. For each case and kernel it prints the
wrapper's time per call three ways: `_ms`, CUDA events, best of 3 x 10
calls; `_mean_ms`, CUDA events, the mean of 10 calls after one, as
`chip_smoke.py` times; `_device_ms`, the summed device time of the
kernels the calls launched (torch.profiler), which leaves out the host's
share. Also whether t, ids and the clusters swept per block equal its
twin's, the block rule's swept pairs and their bound (ops/bounds.py), and
the per-block swept distribution. Where the checkout has work items
(`trace_cluster.item_sweeps`), also the pairs the kernel swept and their
bound, and `work_order_ms`, the schedule's plain version (a stable
torch.argsort; the kernels rank the blocks in a small kernel of their
own). Prints one JSON line. Needs a CUDA device and nvcc; no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SLICE = 131072


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else here)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("compare_trace_cluster_kernels: needs a CUDA device",
              file=sys.stderr)
        return 2
    from neural_renderer_tpu_torch import config as nr_config
    from neural_renderer_tpu_torch.ops import (bounds, trace_cluster,
                                               traversal)
    from neural_renderer_tpu_torch.render import pathtrace as pt
    from neural_renderer_tpu_torch.render.renderer import (RenderBasis,
                                                           Renderer)
    from neural_renderer_tpu_torch.scene.scene import Scene
    dev = torch.device("cuda")

    def time_ms(fn, reps=10):
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

    def mean_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps=10):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   ) / 1e3 / reps

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"tree": tree, "card": smi}

    cfg = nr_config.load_config(os.path.join(here, "configs", "knot",
                                             "knot_lane.json"))
    rend = Renderer(Scene.from_config(cfg), cfg.neural_network, device=dev)
    mesh = rend._mesh_tensors("original_mesh")
    pos, yaw, pitch = nr_config.matrix_to_camera_state(cfg.camera.matrix)
    rend.set_camera_basis(RenderBasis(*nr_config.camera_basis_from_state(
        yaw, pitch, cfg.camera.yfov)))
    rend.resize(1920, 1080)
    rend.set_bounce_count(cfg.rendering.bounce_count)
    params = rend._build_params(pos, 0)
    pix, samp, _, orig, dirs = pt.primary_rays(params)

    def operands(o, d):
        order = traversal._ray_sort_order(o, d, None)
        o, d = o[:, order], d[:, order]
        inside = torch.nonzero(trace_cluster.mesh_exit_t(
            o, d, mesh.cluster_bounds, None) > 0).squeeze(1)
        mid = int(inside[inside.numel() // 2])
        start = max(0, min(o.shape[1] - SLICE, mid - SLICE // 2))
        start -= start % 512
        ops = traversal.clustered_trace_operands(
            mesh, o[:, start:start + SLICE].contiguous(),
            d[:, start:start + SLICE].contiguous())
        assert not bool(ops[7].any())
        return ops[:7]

    hits = pt.trace_primary_gt(mesh, params, orig, dirs)
    rays = pt.sample_bounce_directions(params, pix, samp, hits, hits.hit,
                                       None)
    act = torch.nonzero(hits.hit & (rays.pdf > 0)).squeeze(1)
    cases = {"camera": (operands(orig, dirs), traversal.FORWARD_ONLY),
             "bounce": (operands(rays.origin[:, act],
                                 rays.direction[:, act]), traversal.ANY)}
    del hits, rays, orig, dirs

    has_items = hasattr(trace_cluster, "item_sweeps")
    for label, (args, mode) in cases.items():
        swept = torch.zeros_like(args[5])
        t, tri = trace_cluster.trace_clusters_stream(*args, mode, True,
                                                     swept, mxu=False)
        swept_t = torch.zeros_like(args[5])
        tt, ttri = trace_cluster.trace_clusters_twin(*args, mode, True,
                                                     swept_t)
        swept_m = torch.zeros_like(args[5])
        mt, mtri = trace_cluster.trace_clusters_stream(*args, mode, True,
                                                       swept_m, mxu=True)
        swept_mt = torch.zeros_like(args[5])
        mt_t, mt_tri = trace_cluster.trace_clusters_twin(*args, mode, True,
                                                         swept_mt, mxu=True)
        pairs = int(swept.sum()) * 512 * trace_cluster.CLUSTER_SIZE
        res = {}
        for key, mxu in (("K5", False), ("K5_MXU", True)):
            def call(mxu=mxu):
                return trace_cluster.trace_clusters_stream(*args, mode,
                                                           mxu=mxu)

            res[f"{key}_ms"] = time_ms(call)
            res[f"{key}_mean_ms"] = mean_ms(call)
            res[f"{key}_device_ms"] = device_ms(call)
        res.update({
            "K5_exact": bool(torch.equal(t, tt) and torch.equal(tri, ttri)
                             and torch.equal(swept, swept_t)),
            "K5_MXU_exact": bool(torch.equal(mt, mt_t)
                                 and torch.equal(mtri, mt_tri)
                                 and torch.equal(swept_m, swept_mt)),
            "listed": int(args[5].sum()), "swept": int(swept.sum()),
            "blocks": int(swept.numel()),
            "blocks_none": int((swept == 0).sum()),
            "swept_max": int(swept.max()),
            "swept_mean": float(swept.float().mean()),
            "block_pairs": pairs,
            "K5_bound_ms": bounds.trace_seconds("local", pairs) * 1e3,
            "K5_MXU_bound_ms": bounds.mxu_seconds(pairs) * 1e3})
        if has_items:
            res["work_order_ms"] = time_ms(
                lambda: trace_cluster.work_order(args[5]))
            for key, mxu in (("K5", False), ("K5_MXU", True)):
                ipairs = trace_cluster.item_sweeps(*args, mode,
                                                   mxu=mxu)["pairs"]
                res[f"{key}_item_rays"] = trace_cluster.ITEM_RAYS
                res[f"{key}_item_pairs"] = ipairs
                res[f"{key}_item_bound_ms"] = 1e3 * (
                    bounds.mxu_seconds(ipairs) if mxu
                    else bounds.trace_seconds("local", ipairs))
        out[label] = res

    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
