#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths: the 1920x1080, 1 spp, 3-bounce neural frame of
the shelled-sphere scene (inner/outer UV-sphere shells of 2,304 triangles
each, lane grid S=16, entry_pack=2; the trained sphere weights from
configs/sphere/lane16_step24000.npz and seeded ones), the `evaluate` app on
the knot scene (configs/knot/knot_lane.json: a 65,536-triangle ground-truth
mesh, shells of 9,216 triangles each, the trained 48k-step weights), and a
small-shell scene. Phases, each failing the run:

  1. build every CUDA kernel of the path from neural_renderer_tpu_torch/csrc
     (one nvcc per source, in parallel);
  2. hold each kernel against its PyTorch twin on inputs taken from the
     1080p frame: the clustered sweep (camera fwd2 sweep and one bounce
     sweep, 131,072 rays each) and the dense trace bit-exact, the fused
     network within 2e-2 of the largest output; time kernel and twin;
  3. render 480x270 through the kernels and through the twins on the card
     and compare the images (under 2% of pixels off by more than 3, mean
     difference under 1.0);
  4. render the full-size frame (one warm-up, two timed) with seeded
     weights and every launch counter set to 0 first, check every kernel
     launched, then time the trained weights the same way;
  5. hold the clustered closest-hit kernel against its twin, bit-exact in
     t, triangle id and clusters swept, on 131,072-ray slices of the knot's
     sorted 1080p camera rays (FORWARD_ONLY) and first bounce rays (ANY);
  6. hold the dense dual-shell sweep kernel against its twin, bit-exact on
     every row with and without the second forward crossing, on 131,072
     camera rays against shells of 1,024 triangles each;
  7. run `evaluate` on the knot at 480x270 with the config's 64 samples and
     hold it to the JAX package's gate for this scene (PSNR >= 40.2 dB, mean
     FLIP <= 0.018), then at 1920x1080 with 8 samples in one batch, every
     launch counter set to 0 first: the closest-hit kernel must launch in
     the ground-truth pass, the clustered sweep and the network in the
     neural pass;
  8. render a procedural small-shell scene at 480x270 through the Renderer,
     kernels against twins on the card: the two images must be identical,
     with the dense sweep's counter above 0;
  9. hold the training kernels against their twins on 131,072 segments the
     port's sampler draws from the knot (3 per ray), with the 48k-step knot
     weights in training layout: the training forward (K2 at entry_pack 1,
     32 rows) within K2's 2e-2, every gradient of the network backward (K6)
     under the loss's own cotangent within 1e-3 of the twin's largest
     |grad| (f32 atomics reorder the sums); time kernel, twin and a library
     version;
 10. score the 48k-step weights on one sampled 16,384 x 3 batch (total loss
     under 0.03), then train 100 steps from seeded weights through
     `cli/train.py` (16,384 segments x 3 per ray, cosine schedule), every
     launch counter set to 0 first: the loss must at least halve, K2 and K6
     must launch, and the checkpoint must load in the Renderer and render
     through `evaluate`;
 11. time training steps (Msegments/s, synchronised, after a warm-up step)
     at 262,144 segments: the knot at 3 per ray, the sphere at 1.

Prints the card's name and power limit, a JSON line describing each kernel,
and as the last line {"ok": true, "device": {...}}. Exits non-zero, without
that line, when there is no CUDA device or the package is missing.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
MT_OPS = 45          # FP32 operations per (ray, triangle) pair
SLICE = 131072       # rays per kernel-vs-twin comparison

W, H, SPP, BOUNCES = 1920, 1080, 1, 3


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=10):
    """Mean device time of fn() in ms over reps launches (CUDA events)."""
    import torch
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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import neural_renderer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})",
              file=sys.stderr)
        return 3

    from neural_renderer_tpu_torch import config as nr_config
    from neural_renderer_tpu_torch.cli import evaluate
    from neural_renderer_tpu_torch.cli import train as train_cli
    from neural_renderer_tpu_torch.models import convert, nbvh
    from neural_renderer_tpu_torch.ops import (cuda_build, lane_grid_kernel,
                                               lane_grid_train_kernel,
                                               trace_cluster, trace_pallas,
                                               traversal)
    from neural_renderer_tpu_torch.render import neural_frame
    from neural_renderer_tpu_torch.render import pathtrace as pt
    from neural_renderer_tpu_torch.render.neural_march import (
        NeuralContext, _camera_fwd2_entry, segment_inputs)
    from neural_renderer_tpu_torch.render.params import RenderParams
    from neural_renderer_tpu_torch.render.renderer import (RenderBasis,
                                                           Renderer)
    from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
    from neural_renderer_tpu_torch.scene.materials import Material
    from neural_renderer_tpu_torch.scene.mesh import outward_sphere
    from neural_renderer_tpu_torch.scene.scene import Scene
    from neural_renderer_tpu_torch import train as nr_train

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. build ----------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall for "
        f"{sorted(built)}")
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {info['seconds']:.1f} s; " + " | ".join(regs))

    # ---- scene, network, parameters -----------------------------------
    outer_h = outward_sphere(24, 48, 1.15)
    inner_h = outward_sphere(24, 48, 0.85)
    outer, inner = outer_h.to_tensors(dev), inner_h.to_tensors(dev)
    cfg = nbvh.NbvhConfig(log2_hashmap_size=14, base_resolution=16,
                          grid_type="lane", lane_sublanes=16,
                          lane_entry_pack=2)
    net = convert.params_from_numpy(convert.load_params_npz(
        os.path.join(ROOT, "configs", "sphere", "lane16_step24000.npz")),
        cfg, device=dev)
    ctx = NeuralContext(outer, inner, net)
    env = EnvironmentTensors.from_numpy(None, device=dev)
    omin, omax = outer_h.bounds()

    def make_params(w, h, offset=0):
        return RenderParams.make(
            width=w, height=h, samples_per_pixel=SPP, max_bounces=BOUNCES,
            cam_pos=[0.0, 0.0, 3.0], cam_forward=[0.0, 0.0, -1.0],
            cam_right=[1.0, 0.0, 0.0], cam_up=[0.0, 1.0, 0.0], fov_y=0.9,
            material=Material.default(),
            sample_offset=offset, scene_scale=2.0, outer_shell_min=omin,
            outer_shell_inv_extent=1.0 / (omax - omin), device=dev)

    params = make_params(W, H)
    kernels = {}

    # ---- 2. kernels vs twins on the frame's inputs --------------------
    _, _, _, origins, dirs = pt.primary_rays(params)
    mid = (H // 2) * W - SLICE // 2
    o_s, d_s = origins[:, mid:mid + SLICE], dirs[:, mid:mid + SLICE]

    def sweep_case(o, d, with_fwd2, label):
        ops = traversal.clustered_sweep_operands(outer, inner, o, d)
        ker = trace_cluster.sweep_clusters_stream(*ops, with_fwd2=with_fwd2)
        twin = trace_cluster.sweep_clusters_twin(*ops, with_fwd2=with_fwd2)
        torch.cuda.synchronize()
        err = (ker - twin).abs().max().item()
        exact = torch.equal(ker, twin)
        log(f"[K1 {label}] rays {o.shape[1]} max|kernel - twin| {err!r} "
            f"bit-exact {exact}")
        if not exact:
            raise AssertionError(f"K1 {label}: kernel != twin")
        return ops, err

    ops1, err1 = sweep_case(o_s, d_s, True, "camera fwd2 sweep")
    # One bounce sweep: camera hits of the full frame -> bounce rays, the
    # active ones in the stage's sorted compaction order.
    hits = neural_frame.trace_neural_segments(ctx, params, origins, dirs)
    pix, samp, _, _, _ = pt.primary_rays(params)
    rays = pt.sample_bounce_directions(params, pix, samp, hits, hits.hit,
                                       None)
    act = torch.nonzero(hits.hit & (rays.pdf > 0)).squeeze(1)
    order = traversal._ray_sort_order(rays.origin[:, act],
                                      rays.direction[:, act])
    bsel = act[order][:SLICE]
    _, err1b = sweep_case(rays.origin[:, bsel], rays.direction[:, bsel],
                          False, "bounce sweep")
    err1 = max(err1, err1b)

    o3, d3, tp3, bm3 = traversal.dense_trace_operands(outer, o_s, d_s)
    ker3 = trace_pallas.trace_dense(o3, d3, tp3, traversal.FORWARD_ONLY, bm3)
    twin3 = trace_pallas.trace_dense_twin(o3, d3, tp3, traversal.FORWARD_ONLY,
                                          bm3)
    torch.cuda.synchronize()
    err3 = (ker3[0] - twin3[0]).abs().max().item()
    exact3 = torch.equal(ker3[0], twin3[0]) and torch.equal(
        ker3[1].view(torch.int32), twin3[1].view(torch.int32))
    log(f"[K3 outer FORWARD_ONLY] rays {SLICE} max|t kernel - twin| {err3!r}"
        f" ids equal and bit-exact {exact3}")
    if not exact3:
        raise AssertionError("K3: kernel != twin")

    entry_pos, active, _, sw1 = _camera_fwd2_entry(ctx, origins, dirs)
    net_in = segment_inputs(ctx, params, dirs, entry_pos, active, sw=sw1)[0]
    x_s = net_in[:, mid:mid + SLICE].contiguous()
    a_s = active[mid:mid + SLICE]
    mask2 = lane_grid_kernel._block_mask(a_s, SLICE, dev)
    ker2 = lane_grid_kernel.forward_lane(net, x_s, active=a_s)
    twin2 = lane_grid_kernel.forward_lane_twin(net, x_s, mask2)
    torch.cuda.synchronize()
    err2 = (ker2 - twin2).abs().max().item()
    rel2 = err2 / (twin2.abs().max().item() + 1e-9)
    log(f"[K2 march iteration 1] rays {SLICE} (live "
        f"{int(mask2.sum()) * 128}) max|kernel - twin| {err2!r} "
        f"relative {rel2!r}")
    if not rel2 < 2e-2:
        raise AssertionError(f"K2: relative error {rel2} >= 2e-2")

    # Timings at these shapes; bounds from this run's inputs.
    o1, d1, tp1, ids1, cnt1, _ = ops1
    ms1 = time_ms(lambda: trace_cluster.sweep_clusters_stream(*ops1,
                                                              with_fwd2=True))
    pms1 = time_ms(lambda: trace_cluster.sweep_clusters_twin(*ops1,
                                                             with_fwd2=True),
                   reps=3)
    pairs1 = int(cnt1.sum().item()) * trace_cluster.CLUSTER_SIZE * 512
    bytes1 = nbytes(o1, d1, tp1, ids1, cnt1) + 5 * 4 * o1.shape[1]
    kernels["K1"] = dict(
        name="sweep_stream (clustered dual-shell sweep)", route="cuda",
        source="neural_renderer_tpu_torch/csrc/sweep_stream.cu",
        replaces="neural_renderer_tpu/ops/trace_cluster.py:443",
        max_abs_err=err1, ms=ms1, plain_ms=pms1,
        ops=pairs1 * MT_OPS, bytes=bytes1, peak_ops=PEAK_FP32,
        library_ms=None)

    ms3 = time_ms(lambda: trace_pallas.trace_dense(
        o3, d3, tp3, traversal.FORWARD_ONLY, bm3))
    pms3 = time_ms(lambda: trace_pallas.trace_dense_twin(
        o3, d3, tp3, traversal.FORWARD_ONLY, bm3), reps=3)
    # The bound counts the shell's real triangles, not the kernel's padding
    # of them to whole 512-triangle tiles.
    pairs3 = int(bm3.sum().item()) * 512 * outer.num_triangles
    kernels["K3"] = dict(
        name="trace_dense (dense closest hit)", route="cuda",
        source="neural_renderer_tpu_torch/csrc/trace_dense.cu",
        replaces="neural_renderer_tpu/ops/trace_pallas.py:44",
        max_abs_err=err3, ms=ms3, plain_ms=pms3, ops=pairs3 * MT_OPS,
        bytes=nbytes(o3, d3, bm3) + 9 * 4 * outer.num_triangles
        + 2 * 4 * o3.shape[1],
        peak_ops=PEAK_FP32, library_ms=None)

    ms2 = time_ms(lambda: lane_grid_kernel.forward_lane(net, x_s,
                                                        active=a_s))
    pms2 = time_ms(lambda: lane_grid_kernel.forward_lane_twin(net, x_s,
                                                              mask2), reps=3)
    feats = torch.nn.functional.pad(
        nbvh.encode_inputs(net, x_s), (0, cfg.mlp_width - cfg.encoded_dims))
    feats = feats.to(torch.bfloat16).contiguous()
    wts = [w.to(torch.bfloat16) for w in lane_grid_kernel.pack_lane_weights(
        net)]

    def matmul_chain():
        h = feats
        for w in wts[:-1]:
            h = torch.nn.functional.leaky_relu(torch.matmul(h, w.t()),
                                               nbvh.LEAKY_SLOPE)
        return torch.matmul(h, wts[-1].t())

    lib2 = time_ms(matmul_chain)
    live2 = int(mask2.sum().item()) * 128
    ops_k2 = lane_grid_kernel._operands(net)
    macs = (cfg.mlp_hidden_layers * cfg.mlp_width * cfg.mlp_width
            + cfg.padded_output_dims * cfg.mlp_width)
    kernels["K2"] = dict(
        name="lane_grid_forward (fused lane-grid network)", route="cuda",
        source="neural_renderer_tpu_torch/csrc/lane_grid_forward.cu",
        replaces="neural_renderer_tpu/ops/lane_grid_kernel.py:126",
        max_abs_err=err2, ms=ms2, plain_ms=pms2, ops=2 * macs * live2,
        bytes=nbytes(x_s, mask2, ops_k2.tables2d, ops_k2.w_hidden,
                     ops_k2.w_out) + 16 * 4 * SLICE,
        peak_ops=PEAK_BF16, library_ms=lib2)
    for key in ("K1", "K2", "K3"):
        k = kernels[key]
        log(f"[time {key}] kernel {k['ms']:.4f} ms, twin "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}")

    # ---- 3. 480x270 frame: kernels vs twins on the card ----------------
    p_small = make_params(480, 270)
    img_k, _ = neural_frame.render_neural_frame(
        ctx, env, p_small, torch.zeros((3, 480 * 270), device=dev))
    with twin_path(lane_grid_kernel, trace_cluster, trace_pallas,
                   traversal):
        img_t, _ = neural_frame.render_neural_frame(
            ctx, env, p_small, torch.zeros((3, 480 * 270), device=dev))
    diff = (img_k.to(torch.int32) - img_t.to(torch.int32)).abs().float()
    frac3, mean3 = (diff > 3).float().mean().item(), diff.mean().item()
    log(f"[frame 480x270 kernels vs twins] share > 3: {frac3!r}, mean "
        f"|d| {mean3!r}")
    if not (frac3 < 0.02 and mean3 < 1.0):
        raise AssertionError("480x270 kernel frame differs from twin frame")

    # ---- 4. full-size frame ------------------------------------------
    # The counted main-path run uses seeded weights: their random presence
    # logits march more segments, so the FP-grazing re-entry retrace (the
    # dense trace kernel's only caller) fires in every few frames; with the
    # trained weights it may not fire at all. The trained network is timed
    # after it.
    seeded = nbvh.init_params(cfg, torch.Generator().manual_seed(0), dev)
    seeded_ctx = NeuralContext(outer, inner, seeded)
    counters = (trace_cluster.sweep_clusters_stream,
                lane_grid_kernel.forward_lane, trace_pallas.trace_dense)
    for f in counters:
        f.launches = 0
    img, accum = run_frames(seeded_ctx, env, make_params, "seeded")
    launches = {"K1": counters[0].launches, "K2": counters[1].launches,
                "K3": counters[2].launches}
    log(f"[frame {W}x{H} seeded] launches over 3 frames {launches}")
    imgf = img.float()
    if img.shape != (H, W, 3) or not torch.isfinite(accum).all() or \
            not (0 < imgf.mean().item() < 255):
        raise AssertionError("full-size frame is malformed")
    log(f"[frame {W}x{H} seeded] mean u8 {imgf.mean().item():.3f}")
    for key, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{key} was never launched on the main "
                                 "path")
    run_frames(ctx, env, make_params, "trained")

    # One more frame with CUDA events around every kernel wrapper call
    # (wrapper-side preparation included: an upper bound per kernel).
    for label, c in (("seeded", seeded_ctx), ("trained", ctx)):
        totals = frame_kernel_ms(c, env, make_params(W, H, offset=5),
                                 torch.zeros((3, W * H), device=dev),
                                 lane_grid_kernel, trace_cluster, traversal)
        log(f"[frame {W}x{H} {label}] per-frame kernel ms (calls): "
            + ", ".join(f"{k} {v[0]:.3f} ({v[1]})"
                        for k, v in totals.items()))

    # ---- 5. K5 on the knot's rays ---------------------------------------
    knot_cfg_path = os.path.join(ROOT, "configs", "knot", "knot_lane.json")
    kcfg = nr_config.load_config(knot_cfg_path)
    t0 = time.perf_counter()
    kscene = Scene.from_config(kcfg)
    krend = Renderer(kscene, kcfg.neural_network, device=dev)
    gt_mesh = krend._mesh_tensors("original_mesh")
    log(f"[knot] loaded and built in {time.perf_counter() - t0:.2f} s: "
        f"{gt_mesh.num_triangles} triangles, "
        f"{gt_mesh.cluster_bounds.shape[1]} clusters")
    kpos, kyaw, kpitch = nr_config.matrix_to_camera_state(kcfg.camera.matrix)
    krend.set_camera_basis(RenderBasis(*nr_config.camera_basis_from_state(
        kyaw, kpitch, kcfg.camera.yfov)))
    krend.resize(W, H)
    krend.set_bounce_count(kcfg.rendering.bounce_count)
    kparams = krend._build_params(kpos, 0)
    kpix, ksamp, _, korig, kdirs = pt.primary_rays(kparams)

    def k5_case(o, d, mode, label):
        """Sorted rays -> the SLICE-ray window around the middle of those
        that meet the mesh's box -> kernel against twin."""
        order = traversal._ray_sort_order(o, d, None)
        o, d = o[:, order], d[:, order]
        inside = torch.nonzero(trace_cluster.mesh_exit_t(
            o, d, gt_mesh.cluster_bounds, None) > 0).squeeze(1)
        mid_ray = int(inside[inside.numel() // 2])
        start = max(0, min(o.shape[1] - SLICE, mid_ray - SLICE // 2))
        start -= start % 512
        ops = traversal.clustered_trace_operands(
            gt_mesh, o[:, start:start + SLICE].contiguous(),
            d[:, start:start + SLICE].contiguous())
        args, counts = ops[:7], ops[5]
        swept_k, swept_t = torch.zeros_like(counts), torch.zeros_like(counts)
        kt, ktri = trace_cluster.trace_clusters_stream(*args, mode, True,
                                                       swept_k)
        tt, ttri = trace_cluster.trace_clusters_twin(*args, mode, True,
                                                     swept_t)
        torch.cuda.synchronize()
        err = (kt - tt).abs().max().item()
        exact = (torch.equal(kt, tt) and torch.equal(ktri, ttri)
                 and torch.equal(swept_k, swept_t))
        log(f"[K5 {label}] rays {kt.shape[0]} hits {int((kt < 1e30).sum())} "
            f"clusters swept {int(swept_k.sum())} of {int(counts.sum())} "
            f"listed, max|t kernel - twin| {err!r}, t, ids and swept "
            f"bit-exact {exact}")
        if not exact:
            raise AssertionError(f"K5 {label}: kernel != twin")
        if bool(ops[7].any()):
            raise AssertionError(f"K5 {label}: a worklist overflowed")
        ms = time_ms(lambda: trace_cluster.trace_clusters_stream(*args, mode))
        pms = time_ms(lambda: trace_cluster.trace_clusters_twin(*args, mode),
                      reps=2)
        pairs = int(swept_k.sum().item()) * trace_cluster.CLUSTER_SIZE * 512
        entry = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, ops=pairs * MT_OPS,
            bytes=nbytes(*args) + 2 * 4 * kt.shape[0], peak_ops=PEAK_FP32,
            library_ms=None)
        log(f"[time K5 {label}] kernel {ms:.4f} ms, twin {pms:.4f} ms, "
            f"bound {pairs * MT_OPS / PEAK_FP32 * 1e3:.4f} ms")
        return entry

    k5_cam = k5_case(korig, kdirs, traversal.FORWARD_ONLY, "knot camera")
    khits = pt.trace_primary_gt(gt_mesh, kparams, korig, kdirs)
    krays = pt.sample_bounce_directions(kparams, kpix, ksamp, khits,
                                        khits.hit, None)
    kact = torch.nonzero(khits.hit & (krays.pdf > 0)).squeeze(1)
    k5_bounce = k5_case(krays.origin[:, kact], krays.direction[:, kact],
                        traversal.ANY, "knot bounce 1")
    kernels["K5"] = dict(
        k5_cam, name="trace_cluster_stream (clustered closest hit)",
        route="cuda",
        source="neural_renderer_tpu_torch/csrc/trace_cluster_stream.cu",
        replaces="neural_renderer_tpu/ops/trace_cluster.py:242",
        max_abs_err=max(k5_cam["max_abs_err"], k5_bounce["max_abs_err"]))
    del khits, krays, korig, kdirs

    # ---- 6. K4 on small shells ------------------------------------------
    small_outer_h = outward_sphere(16, 32, 1.15)
    small_inner_h = outward_sphere(16, 32, 0.85)
    so, si = small_outer_h.to_tensors(dev), small_inner_h.to_tensors(dev)
    ops4 = traversal.dense_sweep_operands(so, si, o_s, d_s)
    err4 = 0.0
    for fwd2 in (True, False):
        ker4 = trace_pallas.sweep_shells_dense(*ops4[:4], fwd2, ops4[4])
        twin4 = trace_pallas.sweep_shells_dense_twin(*ops4[:4], fwd2, ops4[4])
        torch.cuda.synchronize()
        e = (ker4 - twin4).abs().max().item()
        exact4 = torch.equal(ker4, twin4)
        log(f"[K4 camera sweep fwd2={fwd2}] rays {SLICE} live blocks "
            f"{int(ops4[4].sum())} of {ops4[4].numel()} rows "
            f"{ker4.shape[0]} max|kernel - twin| {e!r} bit-exact {exact4}")
        if not exact4:
            raise AssertionError(f"K4 fwd2={fwd2}: kernel != twin")
        err4 = max(err4, e)
    ms4 = time_ms(lambda: trace_pallas.sweep_shells_dense(*ops4[:4], True,
                                                          ops4[4]))
    pms4 = time_ms(lambda: trace_pallas.sweep_shells_dense_twin(
        *ops4[:4], True, ops4[4]), reps=3)
    real_tris = so.num_triangles + si.num_triangles
    pairs4 = int(ops4[4].sum().item()) * 512 * real_tris
    kernels["K4"] = dict(
        name="sweep_dense (dense dual-shell sweep)", route="cuda",
        source="neural_renderer_tpu_torch/csrc/sweep_dense.cu",
        replaces="neural_renderer_tpu/ops/trace_pallas.py:95",
        max_abs_err=err4, ms=ms4, plain_ms=pms4, ops=pairs4 * MT_OPS,
        bytes=nbytes(ops4[0], ops4[1], ops4[4]) + 9 * 4 * real_tris
        + 5 * 4 * SLICE, peak_ops=PEAK_FP32, library_ms=None)
    log(f"[time K4] kernel {ms4:.4f} ms, twin {pms4:.4f} ms, bound "
        f"{pairs4 * MT_OPS / PEAK_FP32 * 1e3:.4f} ms")

    # ---- 7. evaluate on the knot ----------------------------------------
    all_counters = {
        "K1": trace_cluster.sweep_clusters_stream,
        "K2": lane_grid_kernel.forward_lane, "K3": trace_pallas.trace_dense,
        "K4": trace_pallas.sweep_shells_dense,
        "K5": trace_cluster.trace_clusters_stream}
    out_dir = os.path.join(ROOT, "comparison_output", "smoke_knot")
    text = run_evaluate(evaluate, [knot_cfg_path, "--width", "480",
                                   "--height", "270", "--output", out_dir])
    psnr, flip = parse_metrics(text)
    log(f"[evaluate knot 480x270 x{kcfg.rendering.total_samples}] PSNR "
        f"{psnr!r} dB, FLIP {flip!r} (gate >= 40.2 dB, <= 0.018)")
    if not (psnr >= 40.2 and flip <= 0.018):
        raise AssertionError("knot evaluate misses the quality gate")

    for f in all_counters.values():
        f.launches = 0
    text = run_evaluate(evaluate, [
        knot_cfg_path, "--width", str(W), "--height", str(H),
        "--total-samples", "8", "--batch-spp", "8", "--output",
        out_dir + "_1080p"])
    eval_launches = {k: f.launches for k, f in all_counters.items()}
    psnr8, flip8 = parse_metrics(text)
    log(f"[evaluate knot {W}x{H} x8, one batch of 8 spp] launches "
        f"{eval_launches}, PSNR {psnr8!r} dB, FLIP {flip8!r}")
    for key in ("K5", "K1", "K2"):
        if eval_launches[key] <= 0:
            raise AssertionError(f"{key} was never launched by evaluate")
    if not (psnr8 > 25.0 and flip8 < 0.1):
        raise AssertionError("1080p knot evaluate is malformed")
    launches["K5"] = eval_launches["K5"]

    # ---- 8. the small-shell path through the Renderer ---------------------
    small_scene = Scene(original_mesh=outward_sphere(32, 64, 1.0),
                        inner_shell=small_inner_h, outer_shell=small_outer_h)
    srend = Renderer(small_scene, kcfg.neural_network, device=dev)
    srend.set_network(seeded)
    srend.resize(480, 270)
    srend.set_use_neural_query(True)
    srend.set_camera_basis(RenderBasis(
        [0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], 0.9))
    trace_pallas.sweep_shells_dense.launches = 0
    img_k = srend.render_accumulate([0.0, 0.0, 3.0], 2, batch_spp=1)
    launches["K4"] = trace_pallas.sweep_shells_dense.launches
    with twin_path(lane_grid_kernel, trace_cluster, trace_pallas,
                   traversal):
        img_t = srend.render_accumulate([0.0, 0.0, 3.0], 2, batch_spp=1)
    diff = abs(img_k.astype(int) - img_t.astype(int))
    log(f"[small shells 480x270 kernels vs twins] K4 launches "
        f"{launches['K4']}, identical {bool((diff == 0).all())}, max |d| "
        f"{int(diff.max())}, mean u8 {img_k.mean():.3f}")
    if launches["K4"] <= 0:
        raise AssertionError("K4 was never launched on the small-shell path")
    if not (diff == 0).all() or img_k.std() < 1.0:
        raise AssertionError("small-shell kernel frame differs from the "
                             "twin frame")

    # ---- 9. K6 against its twin on knot segments ------------------------
    ltk = lane_grid_train_kernel
    kmeshes = [krend._mesh_tensors(m) for m in
               ("original_mesh", "outer_shell", "inner_shell")]
    komin, kinv, kradius = nr_train.segment_domain(kscene, dev)
    krow = nr_train.scene_global_row(kscene, dev)
    kgen = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    with torch.no_grad():
        kb = nr_train.sample_segment_batch(kgen, *kmeshes, komin, kinv, SLICE,
                                           kradius, 3, global_row=krow)
    torch.cuda.synchronize()
    log(f"[K6 knot segments] sampled {SLICE} x 3 per ray in "
        f"{time.perf_counter() - t0:.3f} s: valid "
        f"{int(kb.valid.sum())}, present {int(kb.presence.sum())}")
    knet = convert.params_from_numpy(convert.load_params_npz(os.path.join(
        ROOT, "configs", "knot", "lane_step48000.npz")), krend.net_config,
        device=dev)
    x9 = kb.inputs.contiguous()
    out9 = lane_grid_kernel.forward_train(knet, x9)
    twin9 = nbvh.mlp_forward(list(knet.mlp), nbvh.encode_inputs(knet, x9))
    rel9 = ((out9 - twin9).abs().max() / twin9.abs().max()).item()
    log(f"[K2 training layout] rows {x9.shape[1]} relative |kernel - twin| "
        f"{rel9!r}")
    if not rel9 < 2e-2:
        raise AssertionError(f"K2 training layout: relative error {rel9}")
    out_req = out9.detach().requires_grad_(True)
    loss9, _ = nr_train.shell_losses(out_req, kb)
    (g9,) = torch.autograd.grad(loss9, out_req)
    got6 = ltk.backward_lane(knet, x9, g9)
    ref6 = ltk.backward_twin(knet, x9, g9)
    torch.cuda.synchronize()
    err6, worst6 = 0.0, 0.0
    for label, a, b in zip(("lane", "w0", "w1", "w2", "w3", "wout"),
                           [got6[0], *got6[1]], [ref6[0], *ref6[1]]):
        e = (a - b).abs().max().item()
        rel = e / (b.abs().max().item() + 1e-30)
        err6, worst6 = max(err6, e), max(worst6, rel)
        log(f"[K6 {label}] max|kernel - twin| {e!r}, relative to max|twin| "
            f"{rel!r}")
    if not worst6 <= 1e-3:
        raise AssertionError(f"K6: relative error {worst6} > 1e-3")
    ms6 = time_ms(lambda: ltk.backward_lane(knet, x9, g9))
    pms6 = time_ms(lambda: ltk.backward_twin(knet, x9, g9), reps=2)
    lib6 = time_ms(library_backward(knet, x9, g9, lane_grid_kernel), reps=3)
    n9 = x9.shape[1]
    ops_k6 = lane_grid_kernel._operands(knet, train=True)
    kernels["K6"] = dict(
        name="lane_grid_backward (lane-grid network backward, training "
             "layout)", route="cuda",
        source="neural_renderer_tpu_torch/csrc/lane_grid_backward.cu",
        replaces="neural_renderer_tpu/ops/lane_grid_train_kernel.py:128",
        max_abs_err=err6, ms=ms6, plain_ms=pms6,
        ops=3 * 2 * macs * n9,
        bytes=nbytes(x9, g9, ops_k6.w_hidden, ops_k6.w_out)
        + 2 * nbytes(ops_k6.tables2d) + 4 * macs,
        peak_ops=PEAK_BF16, library_ms=lib6)
    log(f"[time K6] kernel {ms6:.4f} ms, twin {pms6:.4f} ms, library "
        f"{lib6:.4f} ms, bound "
        f"{3 * 2 * macs * n9 / PEAK_BF16 * 1e3:.4f} ms (operations)")
    del got6, ref6, out9, twin9, kb

    # ---- 10. training on the knot ---------------------------------------
    with torch.no_grad():
        b10 = nr_train.sample_segment_batch(kgen, *kmeshes, komin, kinv,
                                            16384, kradius, 3,
                                            global_row=krow)
        l10, c10 = nr_train.shell_losses(
            lane_grid_kernel.forward_train(knet, b10.inputs), b10)
    log(f"[train knot] 48k-step weights on 16384 x 3 segments: total loss "
        f"{l10.item()!r} (" + ", ".join(f"{k} {v.item():.5f}"
                                        for k, v in c10.items()) + ")")
    if not l10.item() < 0.03:
        raise AssertionError("knot weights score a loss >= 0.03")
    train_counters = {
        "K1": trace_cluster.sweep_clusters_stream,
        "K2": lane_grid_kernel.forward_lane,
        "K5": trace_cluster.trace_clusters_stream,
        "K6": ltk.backward_lane}
    for f in train_counters.values():
        f.launches = 0
    ckpt_dir = os.path.join(ROOT, "comparison_output", "smoke_train",
                            "knot_ckpt")
    t0 = time.perf_counter()
    text = run_cli(train_cli.main, [
        knot_cfg_path, "--steps", "100", "--batch-size", "16384",
        "--segments-per-ray", "3", "--lr-schedule", "cosine",
        "--log-every", "1", "--ckpt-dir", ckpt_dir],
        keep=lambda ln: not re.match(r"step (\d+)/", ln) or
        int(re.match(r"step (\d+)/", ln).group(1)) % 10 in (0, 1))
    train_launches = {k: f.launches for k, f in train_counters.items()}
    steps10 = re.findall(r"step (\d+)/100 loss=([0-9.]+).*\(([0-9.]+) "
                         r"Msegments/s\)", text)
    first, last = float(steps10[0][1]), float(steps10[-1][1])
    log(f"[train knot 100 steps] {time.perf_counter() - t0:.2f} s, loss "
        f"{first!r} -> {last!r}, {steps10[-1][2]} Msegments/s, launches "
        f"{train_launches}")
    if not (len(steps10) == 100 and last <= 0.5 * first):
        raise AssertionError("training did not halve the loss in 100 steps")
    for key, n in train_launches.items():
        if n <= 0:
            raise AssertionError(f"{key} was never launched by training")
    launches["K6"] = train_launches["K6"]
    ckpt = re.search(r"final checkpoint: (\S+)", text).group(1)
    if not Renderer(kscene, kcfg.neural_network,
                    device=dev).load_weights_from_file(ckpt):
        raise AssertionError("the trained checkpoint does not load")
    text = run_evaluate(evaluate, [
        knot_cfg_path, "--width", "192", "--height", "108",
        "--total-samples", "8", "--ckpt", ckpt, "--output",
        os.path.join(ROOT, "comparison_output", "smoke_train", "eval")])
    psnr10, flip10 = parse_metrics(text)
    log(f"[train knot] 100-step checkpoint through evaluate 192x108 x8: "
        f"PSNR {psnr10!r} dB, FLIP {flip10!r}")

    # ---- 11. timed training steps ----------------------------------------
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_frame
    for scene_name in ("knot", "sphere"):
        profile_torch_frame.train_step(scene_name, 262144, 3, dev)

    out = []
    for key in ("K1", "K2", "K3", "K4", "K5", "K6"):
        k = kernels[key]
        t_ops = k.pop("ops") / k.pop("peak_ops")
        t_bytes = k.pop("bytes") / PEAK_BYTES
        k["bound_ms"] = max(t_ops, t_bytes) * 1e3
        k["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        k["launches"] = launches[key]
        out.append({f: k[f] for f in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def library_backward(net, x, g, lane_grid_kernel):
    """The K6 yardstick: autograd of the bf16 torch.matmul chain (forward
    and backward of the MLP) plus one index_add_ of the table gradient,
    with the encode and the corner indices computed beforehand."""
    import torch
    from neural_renderer_tpu_torch.models import lane_grid, nbvh
    cfg = net.config
    with torch.no_grad():
        enc = nbvh.encode_inputs(net, x)
        feats = torch.nn.functional.pad(
            enc, (0, cfg.mlp_width - enc.shape[1])).to(torch.bfloat16)
        wts = [w.detach().to(torch.bfloat16)
               for w in lane_grid_kernel.pack_lane_weights(net)]
        n_entries = net.lane[0, 0, 0].numel()
        flat, wcs = [], []
        for p in range(cfg.point_count):
            for level in range(cfg.n_levels):
                corners = lane_grid.level_corners(
                    x[3 * p:3 * p + 3], level, cfg.base_resolution,
                    cfg.per_level_scale, n_entries)
                base = (p * cfg.n_levels + level) * cfg.n_features
                for f in range(cfg.n_features):
                    for idx, wc in corners:
                        flat.append((base + f) * n_entries + idx)
                        wcs.append(wc)
        flat = torch.stack(flat).reshape(-1)
        wcs = torch.stack(wcs)                      # [P*L*F*8, N]
        feature = torch.arange(wcs.shape[0], device=x.device) // 8
        gb = g.t().to(torch.bfloat16)

    def run():
        h = feats.detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in wts]
        a = h
        for w in ws[:-1]:
            a = torch.nn.functional.leaky_relu(a @ w.t(), nbvh.LEAKY_SLOPE)
        out = a @ ws[-1].t()
        grads = torch.autograd.grad(out, [h, *ws], grad_outputs=gb)
        d_enc = grads[0].float().t()                 # [128, N]
        d_t = torch.zeros(net.lane.numel(), device=x.device)
        d_t.index_add_(0, flat, (d_enc[feature] * wcs).reshape(-1))
        return d_t, grads[1:]
    return run


def run_cli(main_fn, argv, keep=lambda line: True):
    """main_fn(argv) with its output captured; logs the lines `keep`
    accepts (progress-bar redraws split at carriage returns) and returns all
    of it. Fails unless main_fn returns 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    text = buf.getvalue()
    for line in text.replace("\r", "\n").splitlines():
        if line.strip() and keep(line):
            log("  | " + line)
    if rc != 0:
        raise AssertionError(f"{argv} returned {rc}")
    return text


def run_evaluate(evaluate, argv):
    """The port's evaluate.main(argv) through run_cli, without the progress
    bar's redraws in the log."""
    return run_cli(evaluate.main, argv, keep=lambda ln: " ETA " not in ln)


def parse_metrics(text):
    psnr = re.search(r"PSNR: ([0-9.]+) dB", text)
    flip = re.search(r"FLIP: ([0-9.]+) \(mean\)", text)
    if not (psnr and flip):
        raise AssertionError("evaluate printed no PSNR / FLIP")
    return float(psnr.group(1)), float(flip.group(1))


def run_frames(ctx, env, make_params, label, frames=2):
    """One warm-up frame, then `frames` timed frames of the full-size
    workload with a running accumulation; logs Mrays/s. Returns (image,
    accum)."""
    import torch
    from neural_renderer_tpu_torch.render import neural_frame
    accum = torch.zeros((3, W * H), device=ctx.outer.tris_packed.device)
    t0 = time.perf_counter()
    img, accum = neural_frame.render_neural_frame(ctx, env,
                                                  make_params(W, H), accum)
    torch.cuda.synchronize()
    log(f"[frame {W}x{H} {label}] warm-up {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for i in range(frames):
        img, accum = neural_frame.render_neural_frame(
            ctx, env, make_params(W, H, offset=(i + 1) * SPP), accum)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    mrays = W * H * SPP * frames / dt / 1e6
    log(f"[frame {W}x{H} spp{SPP} b{BOUNCES} {label}] {frames} frames in "
        f"{dt:.4f} s = {mrays!r} Mrays/s")
    return img, accum


@contextlib.contextmanager
def twin_path(lane_grid_kernel, trace_cluster, trace_pallas, traversal):
    """Route the five kernel entry points to their PyTorch twins (on the
    tensors' own device) for the duration of the block."""
    def lane_twin(net, inputs, active=None):
        n = inputs.shape[1]
        npad = -(-max(n, 128) // 128) * 128
        import torch
        x = torch.nn.functional.pad(inputs, (0, npad - n))
        mask = lane_grid_kernel._block_mask(active, npad, inputs.device)
        return lane_grid_kernel.forward_lane_twin(net, x, mask)[:, :n]

    saved = (lane_grid_kernel.forward_lane,
             trace_cluster.sweep_clusters_stream, traversal.trace_dense,
             traversal.sweep_shells_dense,
             trace_cluster.trace_clusters_stream)
    lane_grid_kernel.forward_lane = lane_twin
    traversal.sweep_shells_dense = trace_pallas.sweep_shells_dense_twin
    trace_cluster.trace_clusters_stream = trace_cluster.trace_clusters_twin
    trace_cluster.sweep_clusters_stream = \
        lambda *a, with_fwd2=False: trace_cluster.sweep_clusters_twin(
            *a, with_fwd2=with_fwd2)
    traversal.trace_dense = trace_pallas.trace_dense_twin
    try:
        yield
    finally:
        (lane_grid_kernel.forward_lane, trace_cluster.sweep_clusters_stream,
         traversal.trace_dense, traversal.sweep_shells_dense,
         trace_cluster.trace_clusters_stream) = saved


def frame_kernel_ms(ctx, env, params, accum, lane_grid_kernel, trace_cluster,
                    traversal):
    """Render one frame with CUDA events around each kernel wrapper call;
    returns {kernel: (total ms, calls)}."""
    import torch
    from neural_renderer_tpu_torch.render import neural_frame
    events = {"K1": [], "K2": [], "K3": []}
    saved = (trace_cluster.sweep_clusters_stream,
             lane_grid_kernel.forward_lane, traversal.trace_dense)

    def timed(key, fn):
        def run(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            r = fn(*a, **kw)
            e.record()
            events[key].append((s, e))
            return r
        run.launches = 0
        return run

    trace_cluster.sweep_clusters_stream = timed("K1", saved[0])
    lane_grid_kernel.forward_lane = timed("K2", saved[1])
    traversal.trace_dense = timed("K3", saved[2])
    try:
        neural_frame.render_neural_frame(ctx, env, params, accum)
        torch.cuda.synchronize()
    finally:
        (trace_cluster.sweep_clusters_stream, lane_grid_kernel.forward_lane,
         traversal.trace_dense) = saved
    return {k: (sum(s.elapsed_time(e) for s, e in v), len(v))
            for k, v in events.items()}


if __name__ == "__main__":
    sys.exit(main())
