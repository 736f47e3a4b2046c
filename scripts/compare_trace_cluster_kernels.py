"""Time and hold the trace kernels of one checkout of the port: the
clustered closest hit (K5, K5-MXU) and dual-shell sweep (K1, K1-MXU), and
the dense closest hit (K3, K8) and dual-shell sweep (K4, K4-MXU); and the
tcnn-layout fused MLP (K7).

    python scripts/compare_trace_cluster_kernels.py [TREE] [--k7]
    python scripts/compare_trace_cluster_kernels.py [TREE] --k9 \
        [--k9-against JSON]

With --k7 only the K7 cases run. With --k9 only the K9 cases run: the
ablation's closest-hit variants but the probes (local, recip, recipx,
nodiv, bf16 and the eight block and tile rows, K9_WALK) and its bf16
matrix form (mxu_hi3, mxu_lo), on its 262,144 rays x 9,216 triangles,
with the production K3 there (`current`); its sweep variants
(sweep_nodiv, sweep_recip, sweep_recipx, sweep_bf16) on its 262,144
camera rays x 2,304 + 2,304 triangles, with the production K4 there
(`sweep`); each timed as below with the sha256 of its output's bytes.
Under "build", the registers and spills ptxas reported for the dense FP32
libraries if this run compiled them. --k9-against names a file whose last
line is an earlier --k9 run's (another tree's, on the same card): the run
then reports which outputs equal that run's bit for bit and exits 1
unless all of them do.

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
one call.

Dense matrix-form cases, K8 (the dense closest hit, `trace_mxu.
trace_dense_mxu`) and K4-MXU (the dense dual-shell sweep, `trace_pallas.
sweep_shells_dense_mxu`): (e) K8 on phase 17's slice, (a)'s 131,072 camera
rays against the outer sphere shell (2,304 triangles), FORWARD_ONLY, K3's
block mask; (f) K8 at the seeded 1080p sphere frame's own launches under
NR_TRACE_MXU=1 (the FP-grazing re-entry retraces of
render/neural_march.py, recorded during one frame and replayed, each with
its N and live blocks); (g) K8 on the trace-kernel ablation's `mxu_hi`
operands (scripts/ablate_trace_kernel_torch.py: 262,144 rays x 9,216
triangles, all-ones mask, ANY); (h) K4-MXU on phase 6's small-shell camera
sweep (1,024 + 1,024 triangles) on (a)'s rays, fwd2; (i) K4-MXU on the
ablation's `sweep_mxu` operands (262,144 camera rays x (2,304 + 2,304)),
fwd2. The FP32 dense kernels on the same operands: K3 (e), (f) (the
default seeded frame's own launches, the same retraces), (g) (the
ablation's `current`), K4 (h), (i) (the ablation's `sweep`). Each with its
bound on the live blocks' real pairs and whether it equals its twin bit
for bit (`trace_dense_twin`/`sweep_shells_dense_twin`, with mxu=True for
the matrix form, in 32,768-ray twin calls), with the pairs its prefilter
leaves where the checkout has one (the FP32 kernels' bound then counts
them, `mt46_bound_ms` Möller–Trumbore's 46 operations on every pair;
this checkout's `chip_smoke.py`: `dense_case`, and `recording_dense` for
the frame's launches). End to end: the seeded 1080p sphere frame and the
seeded small-shell frame in the default formulation (through K3 and K4),
and with NR_TRACE_MXU=1 the seeded and the trained sphere frames
(`chip_smoke.py` phase 18) and the seeded small-shell frame (phase 19's
scene, through K4-MXU): wall ms per frame and, over one profiled frame,
the device ms of all kernels and of the dense ones.

K7 cases, `chip_smoke.py` phase 12's (`sphere_json_segments`): the
sphere.json network's 131,072-segment slice of its 1080p frame's first
march iteration, and the first 2^21-row ENC_CHUNK chunk and the shorter
last chunk of the 1080p x 8 pass's first iteration. Each is timed from
the same f32 rows (`encode_inputs`) on both trees: a checkout with
`pack_input` (bf16 [N, 128] rows) as `pack_input` + `launch` on weights
packed beforehand (`K7` keys) and as `launch` on rows packed beforehand
(`K7_kernel`); a later one as `fused_mlp` (its weight image cached) and
as `launch` on the packed image. With the largest |kernel - twin| over
the twin's largest |output| and, where the checkout has
`bounds.mlp_seconds`, the bound.

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


K9_WALK = ("local", "recip", "recipx", "nodiv", "bf16", "b256", "b1024",
           "t256", "t512", "b256t256", "t256nodiv", "t1024", "b1024t512")
K9_MATRIX = ("mxu_hi3", "mxu_lo")
K9_SWEEPS = ("sweep_nodiv", "sweep_recip", "sweep_recipx", "sweep_bf16")
K9_LABELS = ("current",) + K9_WALK + K9_MATRIX + ("sweep",) + K9_SWEEPS


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = sys.argv[1:]
    against = None
    if "--k9-against" in argv:
        i = argv.index("--k9-against")
        against = argv[i + 1]
        del argv[i:i + 2]
    args = [a for a in argv if a not in ("--k7", "--k9")]
    tree = os.path.abspath(args[0] if args else here)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("compare_trace_cluster_kernels: needs a CUDA device",
              file=sys.stderr)
        return 2
    from neural_renderer_tpu_torch import config as nr_config
    from neural_renderer_tpu_torch.models import convert, nbvh
    from neural_renderer_tpu_torch.ops import (bounds, trace_cluster,
                                               trace_mxu, trace_pallas,
                                               traversal)
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

    def times(call):
        return {"ms": time_ms(call), "mean_ms": mean_ms(call),
                "device_ms": device_ms(call)}

    def timings(res, key, call):
        res.update({f"{key}_{k}": v for k, v in times(call).items()})

    def mxu_bound_ms(pairs, ops, walks, mode):
        """K1-MXU's or K5-MXU's bound on `pairs` swept pairs, its
        conversions on the pairs `trace_cluster.epilogue_pairs` counts in
        these walks (an earlier checkout without it: as it bounded them)."""
        if not hasattr(trace_cluster, "epilogue_pairs"):
            return bounds.mxu_seconds(pairs) * 1e3
        return bounds.mxu_seconds(pairs, converted=trace_cluster
                                  .epilogue_pairs(*ops[:4], walks, mode)) \
            * 1e3

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
    if "--k9" in argv:
        out.update(k9_cases(torch, times, here))
        rc = 0
        if against is not None:
            with open(against) as f:
                ref = json.loads(f.read().strip().splitlines()[-1])
            out["equal_to"] = ref["tree"]
            for label in K9_LABELS:
                out[label]["equal"] = (out[label]["sha256"]
                                       == ref[label]["sha256"])
            rc = 0 if all(out[k]["equal"] for k in K9_LABELS) else 1
        print(json.dumps(out), flush=True)
        return rc
    out.update(k7_cases(torch, dev, times, here))
    if "--k7" in sys.argv:
        print(json.dumps(out), flush=True)
        return 0

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
    rays, act = pt.sample_bounce(params, pix, samp, hits, hits.hit, None)
    act = torch.nonzero(act).squeeze(1)
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
            "K5_MXU_bound_ms": mxu_bound_ms(
                pairs, args, swept_m[:, None].expand(
                    -1, 512 // trace_cluster.ITEM_RAYS), mode)})
        if has_items:
            res["work_order_ms"] = time_ms(
                lambda: trace_cluster.work_order(args[5]))
            for key, mxu in (("K5", False), ("K5_MXU", True)):
                items = trace_cluster.item_sweeps(*args, mode, mxu=mxu)
                ipairs = items["pairs"]
                res[f"{key}_item_rays"] = trace_cluster.ITEM_RAYS
                res[f"{key}_item_pairs"] = ipairs
                res[f"{key}_item_bound_ms"] = (
                    mxu_bound_ms(ipairs, args, items.get("walks"), mode)
                    if mxu else bounds.trace_seconds("local", ipairs) * 1e3)
        out[label] = res
    del cases

    # ---- K1, K1-MXU: the sphere frame's sweeps and the knot's -----------
    outer_h = outward_sphere(24, 48, 1.15)
    outer = outer_h.to_tensors(dev)
    inner = outward_sphere(24, 48, 0.85).to_tensors(dev)
    omin, omax = outer_h.bounds()

    def make_sparams(offset=0):
        return RenderParams.make(
            1920, 1080, 1, 3, [0.0, 0.0, 3.0], [0.0, 0.0, -1.0],
            [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], 0.9, Material.default(),
            sample_offset=offset, scene_scale=2.0, outer_shell_min=omin,
            outer_shell_inv_extent=1.0 / (omax - omin), device=dev)

    sparams = make_sparams()
    spix, ssamp, _, sorig, sdirs = pt.primary_rays(sparams)
    mid = 540 * 1920 - SLICE // 2
    net_cfg = nbvh.NbvhConfig(log2_hashmap_size=14, base_resolution=16,
                              grid_type="lane", lane_sublanes=16,
                              lane_entry_pack=2)
    net = convert.params_from_numpy(convert.load_params_npz(
        os.path.join(here, "configs", "sphere", "lane16_step24000.npz")),
        net_cfg, device=dev)
    shits = neural_frame.trace_neural_segments(
        NeuralContext(outer, inner, net), sparams, sorig, sdirs)
    srays, sact = pt.sample_bounce(sparams, spix, ssamp, shits, shits.hit,
                                   None)
    sact = torch.nonzero(sact).squeeze(1)
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
               "K1_MXU_bound_ms": mxu_bound_ms(
                   pairs, ops, counts[:, None].expand(
                       -1, 512 // trace_cluster.ITEM_RAYS), 0)}
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

    out.update(dense_cases(
        torch, dev, times, trace_mxu, trace_pallas, traversal,
        outer, outward_sphere, sorig[:, mid:mid + SLICE].contiguous(),
        sdirs[:, mid:mid + SLICE].contiguous(), make_sparams, net_cfg, net,
        inner, here))

    print(json.dumps(out), flush=True)
    return 0


def chip_smoke(here):
    """This checkout's chip_smoke.py as a module (its helpers import the
    package lazily, so they take whichever tree's package runs)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def k7_cases(torch, dev, times, here):
    """K7 on the cases of the module docstring: {label: {...}} with rows,
    times, error against the twin and bound."""
    from neural_renderer_tpu_torch.models import nbvh
    from neural_renderer_tpu_torch.ops import bounds
    from neural_renderer_tpu_torch.ops import fused_network as fm
    _, net, x_slice, _, x8 = chip_smoke(here).sphere_json_segments(
        dev, 1920, 1080, SLICE)
    n8 = x8.shape[1]
    tail = n8 - (n8 - 1) // nbvh.ENC_CHUNK * nbvh.ENC_CHUNK
    cases = {"k7_slice": x_slice,
             "k7_first_chunk": x8[:, :nbvh.ENC_CHUNK],
             "k7_last_chunk": x8[:, n8 - tail:]}
    res = {}
    for label, x in cases.items():
        enc = nbvh.encode_inputs(net, x)
        if hasattr(fm, "pack_input"):
            wh, wo = fm.pack_weights(net)
            rows = fm.pack_input(enc)

            def call():
                return fm.launch(fm.pack_input(enc), wh, wo)

            def kernel():
                return fm.launch(rows, wh, wo)
        else:
            rows = enc
            image = fm.weight_image(net)

            def call():
                return fm.fused_mlp(net, enc)

            def kernel():
                return fm.launch(enc, image)
        twin = fm.apply_fused_twin(net, rows)
        r = {"rows": int(enc.shape[0]),
             "max_rel_err": float((call() - twin).abs().max()
                                  / twin.abs().max())}
        del twin
        if hasattr(bounds, "mlp_seconds"):
            r["bound_ms"] = bounds.mlp_seconds(
                r["rows"], net.config.mlp_n_params, 4 * enc.shape[1],
                4 * 16) * 1e3
        r.update({f"K7_{k}": v for k, v in times(call).items()})
        r.update({f"K7_kernel_{k}": v for k, v in times(kernel).items()})
        res[label] = r
        del enc, rows
    return res


def k9_cases(torch, times, here):
    """The K9 cases of the module docstring: {label: {"sha256", times}}
    and "build", on the ablation's workloads (this checkout's
    scripts/ablate_trace_kernel_torch.py, whichever tree's package runs)."""
    import hashlib
    from neural_renderer_tpu_torch.ops import cuda_build
    sys.path.insert(0, os.path.join(here, "scripts"))
    import ablate_trace_kernel_torch as ablate
    built = cuda_build.build(["trace_dense", "sweep_dense", "ablate_trace",
                              "ablate_sweep"])
    res = {"build": {name: [ln.strip() for ln in info["log"].splitlines()
                            if "registers" in ln or "spill" in ln]
                     for name, info in built.items()}}
    o, d, tris = ablate.trace_workload(9216, 262144, "cuda")
    so, sd, stris, cols = ablate.sweep_workload(262144, "cuda")
    for label in K9_LABELS:
        if label == "sweep" or label in K9_SWEEPS:
            fn, x = ablate.sweep_fn(label, so, sd, stris, cols), so
        else:
            fn, x = ablate.trace_fn(label, o, d, tris)[0], o
        out = fn(x).cpu().numpy()
        res[label] = {"sha256": hashlib.sha256(out.tobytes()).hexdigest(),
                      **times(lambda: fn(x))}
    return res


TWIN_CHUNK = 32768   # rays per twin call on the many-wave cases
# Names of the dense kernels of any checkout of the port, FP32 (K3, K4) and
# matrix form (K8, K4-MXU, their feature pass), and of their slices' fold.
DENSE_KERNELS = ("trace_dense", "sweep_dense", "nr_dx_", "nr_dense_fold")


def dense_cases(torch, dev, times, trace_mxu, trace_pallas, traversal,
                outer, outward_sphere, o_s, d_s, make_sparams, net_cfg, net,
                inner, here):
    """The dense matrix-form cases (e)-(i) of the module docstring:
    {label: {...}} with each case's rays, live blocks, bound, times and
    bit-exactness to its twin, through chip_smoke.py's `dense_case` and
    `recording_dense` (this checkout's, whichever tree's package runs)."""
    from neural_renderer_tpu_torch.render import neural_frame
    from neural_renderer_tpu_torch.render.neural_march import NeuralContext
    from neural_renderer_tpu_torch.models import nbvh
    from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
    sys.path.insert(0, os.path.join(here, "scripts"))
    import ablate_trace_kernel_torch as ablate
    smoke = chip_smoke(here)
    fwd = traversal.FORWARD_ONLY
    res = {}

    def chunked(twin, o, d, mask):
        """twin over TWIN_CHUNK-ray chunks of the rays and their flags."""
        return torch.cat([twin(o[:, i:i + TWIN_CHUNK].contiguous(),
                               d[:, i:i + TWIN_CHUNK].contiguous(),
                               mask[i // 512:(i + TWIN_CHUNK) // 512])
                          for i in range(0, o.shape[1], TWIN_CHUNK)], dim=1)

    def k8_case(o, d, tp, mode, mask, real_tris):
        return smoke.dense_case(
            lambda: trace_mxu.trace_dense_mxu(o, d, tp, mode, mask),
            lambda: chunked(lambda a, b, m: trace_pallas.trace_dense_twin(
                a, b, tp, mode, m, mxu=True), o, d, mask),
            (o, d, tp, mask), mode, real_tris, times)

    def k4m_case(o, d, tp, cols, mask, real_tris):
        return smoke.dense_case(
            lambda: trace_pallas.sweep_shells_dense_mxu(o, d, tp, cols, True,
                                                        mask),
            lambda: chunked(lambda a, b, m: trace_pallas
                            .sweep_shells_dense_twin(a, b, tp, cols, True, m,
                                                     mxu=True), o, d, mask),
            (o, d, tp, mask), 0, real_tris, times)

    def k3_case(o, d, tp, mode, mask, real_tris):
        return smoke.dense_case(
            lambda: trace_pallas.trace_dense(o, d, tp, mode, mask, mxu=False),
            lambda: chunked(lambda a, b, m: trace_pallas.trace_dense_twin(
                a, b, tp, mode, m), o, d, mask),
            (o, d, tp, mask), mode, real_tris, times, fp32=True)

    def k4_case(o, d, tp, cols, mask, real_tris):
        return smoke.dense_case(
            lambda: trace_pallas.sweep_shells_dense(o, d, tp, cols, True,
                                                    mask, mxu=False),
            lambda: chunked(lambda a, b, m: trace_pallas
                            .sweep_shells_dense_twin(a, b, tp, cols, True, m),
                            o, d, mask),
            (o, d, tp, mask), 0, real_tris, times, fp32=True)

    # (e) phase 17's K8 slice, phase 2's K3 slice.
    o3, d3, tp3, bm3 = traversal.dense_trace_operands(outer, o_s, d_s)
    res["e_k8_outer_fwd"] = k8_case(o3, d3, tp3, fwd, bm3,
                                    outer.num_triangles)
    res["e_k3_outer_fwd"] = k3_case(o3, d3, tp3, fwd, bm3,
                                    outer.num_triangles)

    # (f) the seeded 1080p frame's own K8 launches (NR_TRACE_MXU=1).
    seeded = nbvh.init_params(net_cfg, torch.Generator().manual_seed(0),
                              dev)
    ctx = NeuralContext(outer, inner, seeded)
    env = EnvironmentTensors.from_numpy(None, device=dev)
    saved = os.environ.get("NR_TRACE_MXU")
    os.environ["NR_TRACE_MXU"] = "1"
    frames = 0
    try:
        with smoke.recording_dense(traversal, trace_mxu) as calls:
            while not calls and frames < 3:
                neural_frame.render_neural_frame(
                    ctx, env, make_sparams(frames),
                    torch.zeros((3, 1920 * 1080), device=dev))
                frames += 1
    finally:
        if saved is None:
            os.environ.pop("NR_TRACE_MXU", None)
        else:
            os.environ["NR_TRACE_MXU"] = saved
    torch.cuda.synchronize()
    res["f_k8_frame_launches"] = {
        "frames": frames,
        "launches": [k8_case(*c, outer.num_triangles) for c in calls]}
    del calls
    # ... and K3's in the default formulation.
    frames = 0
    with smoke.recording_dense(traversal, trace_mxu, matrix=False) as calls:
        while not calls and frames < 3:
            neural_frame.render_neural_frame(
                ctx, env, make_sparams(frames),
                torch.zeros((3, 1920 * 1080), device=dev))
            frames += 1
    torch.cuda.synchronize()
    res["f_k3_frame_launches"] = {
        "frames": frames,
        "launches": [k3_case(*c, outer.num_triangles) for c in calls]}
    del calls

    # (g) the ablation's mxu_hi operands.
    o, d, tris = ablate.trace_workload(9216, 262144, dev)
    tp = ablate.padded(tris, trace_pallas.TRI_TILE)
    ones = torch.ones(o.shape[1] // 512, dtype=torch.int32, device=dev)
    res["g_k8_many_waves"] = k8_case(o, d, tp, traversal.ANY, ones,
                                     tp.shape[1])
    res["g_k3_many_waves"] = k3_case(o, d, tp, traversal.ANY, ones,
                                     tp.shape[1])
    del o, d, tris, tp

    # (h) phase 6's small-shell camera sweep.
    so = outward_sphere(16, 32, 1.15).to_tensors(dev)
    si = outward_sphere(16, 32, 0.85).to_tensors(dev)
    ops4 = traversal.dense_sweep_operands(so, si, o_s, d_s)
    res["h_k4mxu_small_shells"] = k4m_case(
        *ops4[:4], ops4[4], so.num_triangles + si.num_triangles)
    res["h_k4_small_shells"] = k4_case(
        *ops4[:4], ops4[4], so.num_triangles + si.num_triangles)

    # (i) the ablation's sweep_mxu operands.
    o, d, tp, cols = ablate.sweep_workload(262144, dev)
    ones = torch.ones(o.shape[1] // 512, dtype=torch.int32, device=dev)
    res["i_k4mxu_many_waves"] = k4m_case(o, d, tp, cols, ones, tp.shape[1])
    res["i_k4_many_waves"] = k4_case(o, d, tp, cols, ones, tp.shape[1])
    del o, d, tp

    # End to end in the default formulation: the seeded sphere frame
    # (bench.py's, through K3) and the seeded frame on the small shells
    # (through K4); with NR_TRACE_MXU=1 the seeded and trained sphere
    # frames (chip_smoke.py phase 18) and the seeded small-shell frame
    # (phase 19's scene: the dense sweep K4-MXU).
    small = NeuralContext(so, si, seeded)
    trained = NeuralContext(outer, inner, net)
    for label, c in (("frame_seeded", ctx),
                     ("small_shell_frame_seeded", small)):
        res[label] = frame_times(torch, neural_frame, c, env, make_sparams)
    os.environ["NR_TRACE_MXU"] = "1"
    try:
        for label, c in (("mxu_frame_seeded", ctx),
                         ("mxu_frame_trained", trained),
                         ("mxu_small_shell_frame_seeded", small)):
            res[label] = frame_times(torch, neural_frame, c, env,
                                     make_sparams)
    finally:
        if saved is None:
            os.environ.pop("NR_TRACE_MXU", None)
        else:
            os.environ["NR_TRACE_MXU"] = saved
    return res


def frame_times(torch, neural_frame, ctx, env, make_sparams, frames=3):
    """One warm-up 1080p frame, then `frames` frames: the wall ms per frame
    (each ended by a synchronise), and under torch.profiler (one more frame)
    the device ms of all kernels and of the dense kernels, FP32 or matrix
    form (DENSE_KERNELS)."""
    from torch.profiler import ProfilerActivity, profile
    import time

    def frame(i):
        neural_frame.render_neural_frame(
            ctx, env, make_sparams(i),
            torch.zeros((3, 1920 * 1080), device="cuda"))
        torch.cuda.synchronize()

    frame(0)
    walls = []
    for i in range(frames):
        t0 = time.perf_counter()
        frame(i + 1)
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        frame(frames + 1)
    ev = [e for e in prof.key_averages()
          if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dense = [e for e in ev if any(k in e.key for k in DENSE_KERNELS)]
    return {"wall_ms": walls,
            "device_ms": sum(e.self_device_time_total for e in ev) / 1e3,
            "dense_device_ms": sum(e.self_device_time_total
                                   for e in dense) / 1e3,
            "dense_calls": sum(e.count for e in dense)}


if __name__ == "__main__":
    sys.exit(main())
