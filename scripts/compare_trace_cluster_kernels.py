"""Time and hold the clustered kernels of one checkout of the port: the
closest hit (K5, K5-MXU), the dual-shell sweep (K1, K1-MXU) and, for the
matrix sweep code K1-MXU shares, the dense sweep K4-MXU.

    python scripts/compare_trace_cluster_kernels.py [TREE]

Imports neural_renderer_tpu_torch from TREE (default: this checkout), so
two versions compare on one card by running it on each in turns: this
tree and the parent's `git archive` unpacked under the gitignored
`comparison_output/`, in the order A, B, B, A, all in one chip call.

K5 cases, `chip_smoke.py` phase 5's, from the knot scene
(configs/knot/knot_lane.json, 65,536 triangles in 256 clusters): 131,072
of the 1080p camera rays (FORWARD_ONLY) and 131,072 first-bounce rays
(ANY), each sorted as the GT path sorts them and cut around the middle of
the rays that meet the mesh's box. K1 cases: (a) `chip_smoke.py` phase
2's sphere camera fwd2 slice (131,072 rays of the 1080p camera around
the middle row; shells of 2,304 triangles each, 18 clusters) and (b) its
bounce slice (the first 131,072 sorted bounce rays of the trained lane
sphere's 1080p neural frame, no fwd2); (c) 131,072 sorted knot camera
rays with fwd2 against the knot's shells (9,216 triangles each, 72
clusters), cut around the middle of the rays that meet the outer shell's
box; (d) the whole 1080p sphere camera sweep with fwd2, 2,073,600 rays in
one call. K4-MXU: phase 6's small-shell camera sweep (1,024 triangles
each) on (a)'s rays.

For each case and kernel it prints the wrapper's time per call three
ways: `_ms`, CUDA events, best of 3 x 10 calls; `_mean_ms`, CUDA events,
the mean of 10 calls after one, as `chip_smoke.py` times; `_device_ms`,
the summed device time of the kernels the calls launched
(torch.profiler), which leaves out the host's share. Also whether the
kernel equals its twin bit for bit (K5: t, ids and the clusters swept
per block; K1: every row), the swept pairs' bound (ops/bounds.py) and
the per-block count distribution (min, mean, max, and the share of
blocks above 1.5 x the mean). Where the checkout has work items
(`trace_cluster.item_sweeps`), also the pairs K5 swept and their bound,
and `work_order_ms`, the schedule's plain version (a stable
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
    from neural_renderer_tpu_torch.models import convert, nbvh
    from neural_renderer_tpu_torch.ops import (bounds, trace_cluster,
                                               trace_pallas, traversal)
    from neural_renderer_tpu_torch.render import neural_frame
    from neural_renderer_tpu_torch.render import pathtrace as pt
    from neural_renderer_tpu_torch.render.neural_march import NeuralContext
    from neural_renderer_tpu_torch.render.params import RenderParams
    from neural_renderer_tpu_torch.render.renderer import (RenderBasis,
                                                           Renderer)
    from neural_renderer_tpu_torch.scene.materials import Material
    from neural_renderer_tpu_torch.scene.mesh import outward_sphere
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

    def timings(res, key, call):
        res[f"{key}_ms"] = time_ms(call)
        res[f"{key}_mean_ms"] = mean_ms(call)
        res[f"{key}_device_ms"] = device_ms(call)

    def spread(counts):
        c = counts.float()
        mean = float(c.mean())
        return {"count_min": int(counts.min()), "count_mean": mean,
                "count_max": int(counts.max()),
                "share_above_1.5x_mean": float((c > 1.5 * mean).float()
                                               .mean())}

    def sweep_twin(ops, fwd2, mxu, chunk=SLICE):
        """sweep_clusters_twin in chunks of `chunk` rays (whole blocks)."""
        o, d, tp, ids, counts, co = ops
        k = ids.shape[0] // counts.shape[0]
        rows = []
        for s in range(0, o.shape[1], chunk):
            b0, b1 = s // 512, (s + chunk) // 512
            rows.append(trace_cluster.sweep_clusters_twin(
                o[:, s:s + chunk], d[:, s:s + chunk], tp, ids[b0 * k:b1 * k],
                counts[b0:b1], co, fwd2, mxu=mxu))
        return torch.cat(rows, dim=1)

    def window(o, d, cluster_bounds):
        """The SLICE sorted rays around the middle of those that meet the
        boxes' union."""
        order = traversal._ray_sort_order(o, d, None)
        o, d = o[:, order], d[:, order]
        inside = torch.nonzero(trace_cluster.mesh_exit_t(
            o, d, cluster_bounds, None) > 0).squeeze(1)
        mid = int(inside[inside.numel() // 2])
        start = max(0, min(o.shape[1] - SLICE, mid - SLICE // 2))
        start -= start % 512
        return (o[:, start:start + SLICE].contiguous(),
                d[:, start:start + SLICE].contiguous())

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"tree": tree, "card": smi}

    # ---- K5, K5-MXU on the knot -------------------------------------
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
        ops = traversal.clustered_trace_operands(
            mesh, *window(o, d, mesh.cluster_bounds))
        assert not bool(ops[7].any())
        return ops[:7]

    hits = pt.trace_primary_gt(mesh, params, orig, dirs)
    rays = pt.sample_bounce_directions(params, pix, samp, hits, hits.hit,
                                       None)
    act = torch.nonzero(hits.hit & (rays.pdf > 0)).squeeze(1)
    cases = {"camera": (operands(orig, dirs), traversal.FORWARD_ONLY),
             "bounce": (operands(rays.origin[:, act],
                                 rays.direction[:, act]), traversal.ANY)}
    knot_outer = rend._mesh_tensors("outer_shell")
    knot_inner = rend._mesh_tensors("inner_shell")
    knot_sweep = traversal.clustered_sweep_operands(
        knot_outer, knot_inner,
        *window(orig, dirs, knot_outer.cluster_bounds))
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
            timings(res, key, lambda mxu=mxu: trace_cluster
                    .trace_clusters_stream(*args, mode, mxu=mxu))
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
    del cases

    # ---- K1, K1-MXU: the sphere frame's sweeps and the knot's -----------
    outer_h = outward_sphere(24, 48, 1.15)
    outer = outer_h.to_tensors(dev)
    inner = outward_sphere(24, 48, 0.85).to_tensors(dev)
    omin, omax = outer_h.bounds()
    sparams = RenderParams.make(
        1920, 1080, 1, 3, [0.0, 0.0, 3.0], [0.0, 0.0, -1.0],
        [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], 0.9, Material.default(),
        scene_scale=2.0, outer_shell_min=omin,
        outer_shell_inv_extent=1.0 / (omax - omin), device=dev)
    spix, ssamp, _, sorig, sdirs = pt.primary_rays(sparams)
    mid = 540 * 1920 - SLICE // 2
    net = convert.params_from_numpy(convert.load_params_npz(
        os.path.join(here, "configs", "sphere", "lane16_step24000.npz")),
        nbvh.NbvhConfig(log2_hashmap_size=14, base_resolution=16,
                        grid_type="lane", lane_sublanes=16,
                        lane_entry_pack=2), device=dev)
    shits = neural_frame.trace_neural_segments(
        NeuralContext(outer, inner, net), sparams, sorig, sdirs)
    srays = pt.sample_bounce_directions(sparams, spix, ssamp, shits,
                                        shits.hit, None)
    sact = torch.nonzero(shits.hit & (srays.pdf > 0)).squeeze(1)
    sact = sact[traversal._ray_sort_order(srays.origin[:, sact],
                                          srays.direction[:, sact])][:SLICE]
    sweeps = {
        "sphere_camera": (traversal.clustered_sweep_operands(
            outer, inner, sorig[:, mid:mid + SLICE],
            sdirs[:, mid:mid + SLICE]), True),
        "sphere_bounce": (traversal.clustered_sweep_operands(
            outer, inner, srays.origin[:, sact], srays.direction[:, sact]),
            False),
        "knot_camera": (knot_sweep, True),
        "sphere_camera_1080p": (traversal.clustered_sweep_operands(
            outer, inner, sorig, sdirs), True)}
    del shits, srays
    for label, (ops, fwd2) in sweeps.items():
        counts = ops[4]
        pairs = int(counts.sum()) * 512 * trace_cluster.CLUSTER_SIZE
        res = {"rays": int(ops[0].shape[1]), "fwd2": fwd2,
               "clusters": int(ops[2].shape[1]) // trace_cluster.CLUSTER_SIZE,
               "blocks": int(counts.numel()), "listed": int(counts.sum()),
               "block_pairs": pairs, **spread(counts),
               "K1_bound_ms": bounds.trace_seconds("local", pairs) * 1e3,
               "K1_MXU_bound_ms": bounds.mxu_seconds(pairs) * 1e3}
        for key, mxu in (("K1", False), ("K1_MXU", True)):
            ker = trace_cluster.sweep_clusters_stream(*ops, with_fwd2=fwd2,
                                                      mxu=mxu)
            twin = sweep_twin(ops, fwd2, mxu)
            res[f"{key}_exact"] = bool(torch.equal(ker, twin))
            del ker, twin
            timings(res, key, lambda mxu=mxu: trace_cluster
                    .sweep_clusters_stream(*ops, with_fwd2=fwd2, mxu=mxu))
        out[label] = res
    del sweeps

    so = outward_sphere(16, 32, 1.15).to_tensors(dev)
    si = outward_sphere(16, 32, 0.85).to_tensors(dev)
    ops4 = traversal.dense_sweep_operands(so, si, sorig[:, mid:mid + SLICE],
                                          sdirs[:, mid:mid + SLICE])
    res = {"K4_MXU_exact": bool(torch.equal(
        trace_pallas.sweep_shells_dense_mxu(*ops4[:4], True, ops4[4]),
        trace_pallas.sweep_shells_dense_twin(*ops4[:4], True, ops4[4],
                                             mxu=True)))}
    timings(res, "K4_MXU", lambda: trace_pallas.sweep_shells_dense_mxu(
        *ops4[:4], True, ops4[4]))
    out["small_shell_camera"] = res

    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
