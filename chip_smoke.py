#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths: the 1920x1080, 1 spp, 3-bounce neural frame of
the shelled-sphere scene (inner/outer UV-sphere shells of 2,304 triangles
each, lane grid S=16, entry_pack=2; the trained sphere weights from
configs/sphere/lane16_step24000.npz and seeded ones), the `evaluate` app on
the knot scene (configs/knot/knot_lane.json: a 65,536-triangle ground-truth
mesh, shells of 9,216 triangles each, the trained 48k-step weights), a
small-shell scene, training on the knot, and the reference-format sphere
scene (configs/sphere/sphere.json: the tcnn-layout network with the flat
FP16 weights.bin, a 9,216-triangle ground-truth mesh): its `evaluate` and
its training. Phases, each failing the run:

  1. build every CUDA kernel of the path from neural_renderer_tpu_torch/csrc
     (one nvcc per source, in parallel);
  2. hold each kernel against its PyTorch twin on inputs taken from the
     1080p frame: the clustered sweep (camera fwd2 sweep and one bounce
     sweep, 131,072 rays each, and 131,072 sorted camera rays of the knot
     with fwd2 against its shells) and the dense trace bit-exact (on the
     outer shell, FORWARD_ONLY: the 131,072-ray slice and, alone, its first
     live 512-ray block, the launch with the most triangle slices), the
     fused network within 2e-2 of the largest output; time kernel and
     twin (the sweep on every case, its wrapper beside its kernels'
     device time from torch.profiler, its bound and the per-block cluster
     counts), and split the network kernel's time by timing K7 (the MLP
     alone) on the encoded features of the slice's live rows;
  3. render 480x270 through the kernels and through the twins on the card
     and compare the images (under 2% of pixels off by more than 3, mean
     difference under 1.0);
  4. render the full-size frame (one warm-up, two timed) with seeded
     weights and every launch counter set to 0 first, check every kernel
     launched, then time the trained weights the same way;
  5. hold the clustered closest-hit kernel against its twin, bit-exact in
     t, triangle id and clusters swept, on 131,072-ray slices of the knot's
     sorted 1080p camera rays (FORWARD_ONLY) and first bounce rays (ANY);
     log how its work items split each walk (rays per item, the per-block
     swept distribution, the pairs the kernel swept against the block
     rule's, each with its bound; the kernels line's bound_ms counts the
     items' pairs, its block_rule_bound_ms the block rule's; the wrapper's
     time beside its kernels' device time from torch.profiler), holding
     the items' counts to the block rule's by max and the kernel's
     schedule to `work_order`;
  6. hold the dense dual-shell sweep kernel against its twin, bit-exact on
     every row with and without the second forward crossing, on 131,072
     camera rays against shells of 1,024 triangles each and on their first
     live 512-ray block alone; the dense kernels' bounds count the pairs
     their prefilter leaves (the 46 operations per pair beside them);
  7. run `evaluate` on the knot at 480x270 with the config's 64 samples and
     hold it to the JAX package's gate for this scene (PSNR >= 40.2 dB, mean
     FLIP <= 0.018), then at 1920x1080 with 8 samples in one batch, every
     launch counter set to 0 first: the closest-hit kernel must launch in
     the ground-truth pass, the clustered sweep and the network in the
     neural pass;
  8. render a procedural small-shell scene at 480x270 through the Renderer,
     kernels against twins on the card, with the dense sweep's counter above
     0: with the network kernel on both sides the two images must be
     identical (the trace and sweep kernels are bit-exact); with the
     network's twin too, within phase 3's bounds (the network kernel's
     tensor-core sums are not bit-exact);
  9. hold the training kernels against their twins on 131,072 segments the
     port's sampler draws from the knot (3 per ray), with the 48k-step knot
     weights in training layout: the training forward (K2 at entry_pack 1,
     32 rows) within K2's 2e-2, every gradient of the network backward (K6)
     under the loss's own cotangent within 1e-3 of the twin's largest
     |grad| (f32 atomics reorder the sums); time kernel, twin and a library
     version, and the backward's two passes under torch.profiler;
 10. score the 48k-step weights on one sampled 16,384 x 3 batch (total loss
     under 0.03), then train 100 steps from seeded weights through
     `cli/train.py` (16,384 segments x 3 per ray, cosine schedule), every
     launch counter set to 0 first: the loss must at least halve, K2 and K6
     must launch, and the checkpoint must load in the Renderer and render
     through `evaluate`;
 11. time training steps (Msegments/s, synchronised, after a warm-up step)
     at 262,144 segments: the knot at 3 per ray, the sphere at 1;
 12. hold the fused MLP kernel of tcnn-layout networks (K7) against its
     twin on encode_inputs' f32 rows (K7_TOL_ALL, K7_TOL, K7_SHARE: every
     output within 2e-2 of the largest, every channel within 1e-1 of its
     own largest value, at most 1% of the rows beyond 1e-5 x the largest
     output; the hold must reject two planted faults, and 10 calls on
     fresh copies must give the first call's bits), on 131,072 segments
     of the first march iteration of the sphere.json 1080p neural frame
     with the weights.bin weights; time the
     wrapper, the kernel alone, its device time, the twin and a library
     version (a bf16 cast and the torch.matmul chain) beside its bound
     (bounds.mlp_seconds); then the same check and times at phase 14's
     launch shapes, the first 2^21-row chunk and the shorter last chunk of
     the 1080p x 8 march's first iteration;
 13. run `evaluate` on sphere.json at 480x270 with the config's 64 samples
     and hold it to the JAX package's gate (PSNR >= 45.5 dB, mean FLIP <=
     0.018, tests/test_golden.py:101-125);
 14. run it at 1920x1080 with 8 samples in one batch, every launch counter
     set to 0 first: K7 must launch in the neural pass;
 15. load weights.bin and write it back with save_flat_blob: the bytes
     must equal the file's;
 16. train 100 seeded steps of sphere.json through `cli/train.py` (16,384
     segments x 1, cosine schedule): the loss must at least halve, and the
     exported flat FP16 blob (`--out`) must load in the Renderer and render
     through `evaluate`;
 17. the matrix formulation of the traces (NR_TRACE_MXU=1): hold each of
     its four kernels bit-exact to its twin (the dense closest hit in t and
     ids, the dense sweep on every row with and without the second forward
     crossing) and against
     the default kernel (the JAX package's MXU-against-oracle bounds: t
     within 1e-5 relative and 1e-5 absolute with ids on 99.9% for the dense
     trace, 1e-6 absolute with ids on 99% for the sweeps; on the knot, seen
     from beyond those tests' rays, t within 5e-5 relative and 5e-4
     absolute on rays that take the same triangle) on phases 2, 5 and 6's
     inputs: K8 on the outer-shell FORWARD_ONLY slice, K1-MXU on phase
     2's three sweeps (against K1 on the knot within those knot bounds on
     every ray that hits in both, a sweep row having no ids; timed as K1
     is), K4-MXU on the small-shell camera rays, K5-MXU on the knot's
     sorted camera rays and first bounce rays (bit-exact also in clusters
     swept, with phase 5's item log); time kernel, twin and default kernel,
     and for K8, K4-MXU and K1-MXU the device time, the pairs the
     prefilter rule leaves to the epilogue and the bound of each case;
 18. with NR_TRACE_MXU=1, render 480x270 through the MXU kernels and
     through their twins on the card (phase 3's bounds), then the full-size
     frame as phase 4 (seeded weights counted: K1-MXU and K8 must launch,
     the default K1 and K3 not at all; the K8 launches of one untimed
     frame before it recorded and replayed bit-exact to the twin and
     timed; trained weights timed);
 19. with NR_TRACE_MXU=1, run `evaluate` on the knot at 480x270 x 64 and
     hold it to phase 7's gate (K5-MXU and K1-MXU must launch, K5 and K1
     not at all), and render the small-shell scene through K4-MXU and
     through its twin (phase 3's bounds);
 20. the trace-kernel ablation (K9): run scripts/ablate_trace_kernel_torch.py
     over every variant of the reference's dispatch and of its sweep family
     (9,216 triangles x 262,144 rays; sweeps 2,304 + 2,304 x 262,144), every
     ablation launch counter set to 0 first: each new kernel must launch;
     then hold each kernel against its twin on all the rays (bit-exact, but
     recipx's approximate reciprocal within ABLATE_ULPS and the bf16 matrix
     form's tensor-core sums within ABLATE_MXU_BF16) and against the
     production kernels (`local` and the block and tile variants bit-exact
     against K3, `recip` and `sweep_recip` too; nodiv and recipx within
     ABLATE_ULPS; bf16 within ABLATE_BF16; current (K3), sweep (K4),
     mxu_hi (K8) and sweep_mxu (K4-MXU) bit-exact to their twins, the last
     two within phase 17's bounds of K3 and K4); time each twin; log, for
     the kernels behind a prefilter (the trace variants on K3's walk, every
     one but the probes; mxu_hi3, mxu_lo; the sweep variants), the bound on
     the pairs the rule leaves, the bound on every pair and the share the
     rule leaves, and `local`'s time over `current`'s (the same walk at the
     same launch, timed in this run);
 21. run `evaluate` on the shipped lane sphere (configs/sphere/
     sphere_lane.json) at 480x270 x 64 and hold it to 1 dB under the JAX
     record (PSNR >= 50.54 dB, mean FLIP <= 0.018); then run bench_torch.py
     (BENCH_SKIP_CPU=1) and check its last line has bench.py's keys;
 22. the studio scene (configs/studio/studio_lane.json: the PIZ EXR sky,
     the textured, normal-mapped glTF torus of 2,304 triangles, shells of
     800 + 800 triangles, the 398-triangle additional mesh extra.obj, the
     trained lane grid lane_step12000.npz): (a) load it through
     Scene.from_config (a valid 256x128 sky, textures and normal maps on
     the ground-truth mesh); (b) hold at its launch shapes the dense sweep
     (K4) bit-exact to its twin on 131,072 camera rays against the shells
     with and without the second forward crossing, the dense closest hit
     (K3) bit-exact in t and ids on the torus (FORWARD_ONLY, the slice and
     its first live 512-ray block alone) and on extra.obj's first bounce
     rays (ANY), and the network (K2) within 2e-2 on the first march
     iteration; time kernels and twins beside their bounds
     (bounds.dense_seconds for K3, K4); (c) render 480x270 through the
     kernels and through the twins on the card, the hybrid neural frame
     and the ground-truth frame, held to phase 3's bounds; (d) run
     `evaluate --no-additional` at 480x270 with the config's 64 samples
     and hold it to the JAX package's gate for this scene (PSNR >= 23.5
     dB, mean FLIP <= 0.065, tests/test_golden.py:150-174), counters at 0
     first: K3 must launch in the ground-truth pass, K4 and K2 in the
     neural pass, K1 and K5 in neither; (e) run the full hybrid `evaluate`
     at the same size (no gate: the ground truth never traces the
     additional mesh), K3 launching in its neural pass; (f) run it at
     1920x1080 with 8 samples in one batch and log each pass's Mrays/s and
     peak memory;
 23. every scene and image format the JAX package reads: (a) on the host,
     the DWAA / DWAB fixtures against OpenEXR's decodes (at least 99.9% of
     the DCT halfs identical, none more than 4 half-ulps apart, alpha and
     Z bit-exact) and the JPEG fixtures (scripts/make_jpeg_fixture.py)
     against Pillow's decodes byte for byte, through the native and the
     Python entropy paths, each timed; (b) the knot's meshes written from
     the OBJ loader's arrays (scripts/mesh_writers.py) as binary PLY (the
     original, with its normals), STL (outer shell) and FBX (inner shell)
     into a temporary directory: PLY's arrays must equal the OBJ's bit for
     bit, the shells' triangles the OBJ's in order and value (FBX's
     float64 pretransform may turn -0.0 into +0.0); `evaluate` on a copy of
     knot_lane.json naming them at 480x270 x 64, counters at 0 first: K5
     must launch in the ground-truth pass, K1 and K2 in the neural pass,
     the knot gate must hold and PSNR and FLIP must equal phase 7's as
     printed; (c) the studio with --no-additional under the JPEG sky and
     then the DWAB sky: 480x270 frames through the kernels and the twins
     on the card held to phase 3's bounds, and `evaluate` with K3 launching
     in the ground-truth pass, K4 and K2 in the neural pass (PSNR and FLIP
     logged, no gate: the gate was recorded under the PIZ sky); (d)
     `compare_images` with FLIP on the card on each pass's saved PNGs must
     print what `evaluate` printed, on a JPEG of the neural image
     (scripts/jpeg_writer.py) must stay within 1 dB, and on the neural
     image flipped upside down must detect the flip and print the
     unflipped pair's numbers;
 24. the viewer on the lane sphere (configs/sphere/sphere_lane.json, S=16,
     the 24k-step weights) at 1920x1080, counters at 0 before each run
     that counts: (a) `viewer --headless 4` through its main, 1 spp a
     frame: the accumulation must reach 4 spp, K1 and K2 must launch;
     Mrays/s and fps per frame; (b) the same four frames with the
     denoiser: the card's denoised u8 image within 1 step of
     `bilateral_denoise` of the same accumulation and guides on the CPU
     (the share of differing pixels logged), and the denoise's own time
     (CUDA events); (c) the Lambert view, ground truth and neural, at
     480x270 through the kernels and through the twins on the card (ground
     truth identical, neural within phase 3's bounds), the inner shell as
     the classic mesh through K3, and the times at 1920x1080; (d)
     `--bench-motion 3 --motion-drop 4` (a 480x270 preview, then the
     config's 64 spp at rest): preview fps, median frame ms, rest Mrays/s;
     (e) train-while-render, `--headless 3 --train-steps 4 --train-batch
     16384` at 480x270 warm-started from the weights: finite losses, the
     accumulation restarting every frame, K1, K2, K5 and K6 launching, the
     checkpoint written and resumed by `cli/train.py --resume`; train steps
     per second; (f) `profile_renderer` tables, ground truth and neural:
     every category the JAX profiler fills for the branch above 0, the
     ratio of their sum to the whole frame's time; (g) `memory_stats()`
     and the phase's `torch.cuda.max_memory_allocated`;
 25. the multi-GPU paths on the one card, each held exactly: (a) in one
     process, the trained lane sphere at 1920x1080 (spp 1, 3 bounces) in 4
     stripes of 270 rows through `render_neural_frame(row0, n_rows)` and
     the knot's ground-truth frame at 480x270 in 4 stripes (67, 68, 67, 68
     rows), each stitched equal to the whole frame (u8 image,
     accumulation, guides), K1 / K2 / K3 / K5 launches logged per stripe,
     and the denoiser's stripes with halos assembled in the process equal
     to `bilateral_denoise`; (b) `evaluate --dp 5` of the knot at 480x270
     x 64 (270 rows do not split into 4 stripes, and a height the stripes
     do not divide falls back to the whole frame), five ranks sharing the
     card over gloo: PNGs byte-equal to phase 7's, PSNR and FLIP equal,
     Mrays/s of both; and `evaluate --dp 4` at 480x272 byte-equal to one
     process at that size; (c) `viewer --dp 4 --headless 2
     --save-sequence` on the lane sphere at 1920x1080, run as a user runs
     it, its PNGs byte-equal to one process's; the viewer's renderer with
     the denoiser (the x key; the CLI has no flag for it) on 4 ranks, 2
     frames equal to one process's, no fallback, each rank's accumulation a
     quarter of the pixels; `viewer --dp 2 --train-steps 2` at 480x270
     against one process: the losses within 2% (DP_LOSS_TOL), the exit
     checkpoint's moments within 1e-3 of their largest value
     (DP_GRAD_TOL); (d) `train --dp 2 --tp 2` on the knot (16,384
     segments x 3), run as a user runs it: after one step the moments
     within 1e-3 of their largest value of one process's on the same seed
     and the parameters within 1e-6 where the moment is above that, after
     20 steps the loss within 2%, the per-rank network + moment bytes
     against the unsharded ones, steps/s, and the written `.npz` rendered
     by `evaluate`; (e) a world-size-1 NCCL group through the tiled
     functions equal to the plain frames and denoiser; with four GPUs,
     `evaluate --dp 4` at 480x272 over NCCL against one process (else a
     line saying why it did not run); (f) the sphere frame under
     NR_ENTRY_RETRY=trace equal to the default, under
     NR_CAMERA_ENTRY=trace differing from it on under
     1% of the pixels (ENTRY_TRACE_SHARE), K3 / K5 launches of each; (g)
     `train --resume configs/knot/lane_step48000.npz` (the export of the
     JAX package's orbax checkpoint) for 10 steps, without orbax: every
     loss under phase 10's 0.03 bound for the trained weights and the
     first under a tenth of a fresh start's (phase 10's first loss);
 26. the networks the port trained from scratch on the card
     (scripts/ablate_studio_torch.py, scripts/ablate_knot_torch.py,
     `cli/train.py`; PERF.md has the recipes): (a) `evaluate` at 480x270 x
     64 on each committed file through `--ckpt`, held to its scene's gate
     (TRAINED_GATES) and logged beside the JAX-trained weights' scores of
     phases 7, 13 and 22 (the lane sphere's port-trained network is not
     shipped: it missed its gate, ROADMAP Queue 3); (b) the studio recipe
     cut to 500 steps at its full width (65,536 segments x 3, cosine over
     the 500 steps) through `cli/train.py`, counters at 0 first: K4, K3,
     K2 and K6 must launch, and the last loss must fall under
     STUDIO500_LOSS; its Msegments/s logged.

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

# Every bound below is computed from the rates and operation counts of
# neural_renderer_tpu_torch/ops/bounds.py.
# The matrix formulation's bounds (tests/test_trace_mxu.py): its kernels
# against their twins (:128-136); against the default kernels, the dense
# trace (:73-83) and the sweeps and clustered trace (:161-165, :204-212).
MXU_TWIN = dict(rtol=1e-6, atol=1e-6, ids=0.999)
MXU_DENSE_VPU = dict(rtol=1e-5, atol=1e-5, ids=0.999)
MXU_VPU = dict(rtol=1e-5, atol=1e-6, ids=0.99)
# The clustered trace against K5 on the knot, seen from distance 7 (beyond
# the radius-3 rays of those tests): the matrix form's t·det = o·n - v0·n
# cancels f32 terms of size |o||n| where K5 forms o - v0 first, so t's
# error is absolute, |o| eps / |cos|, and grows on grazing rays. Measured
# on the H100: camera rays 1.29e-5 relative (9.3e-5 absolute at t ~ 7),
# first bounce rays 1.18e-4 absolute at t ~ 2e-3. t is held where both
# take the same triangle; a ray that takes another one (an edge of a
# nearer triangle hit by one form only, 1 of 17,204 bounce rays) lies in
# the ids bound.
MXU_KNOT_VPU = dict(rtol=5e-5, atol=5e-4, ids=0.99, t_same_id=True)
SLICE = 131072       # rays per kernel-vs-twin comparison
# The trace-kernel ablation (phase 20). Variants beyond the reference's
# default list: the rest of its dispatch and of its sweep family.
ABLATE_EXTRA = ["t512", "b256t256", "t256probe", "t256nodiv", "t1024",
                "b1024t512", "t512probe", "sweep_mxu", "sweep_recip"]
ABLATE_CHUNK = 32768  # rays per twin call
# nodiv (one divide where the production math multiplies by 1/det) and
# recipx (rcp.approx, about 1 ulp per the PTX ISA) round t differently from
# the production math by a few ulps, and may flip a cull on an edge pair:
# t within 1e-6 relative (8 ulps), flips and ids as phase 17's.
ABLATE_ULPS = dict(rtol=1e-6, atol=0.0, ids=0.999)
# bf16 keeps 8 significant bits: every rounding moves t by up to 2^-9
# relative, bf16 culls decide edge and grazing pairs otherwise than f32 (an
# ANY-mode ray may then take the far side), and its coarse t splits one
# crossing at a shared edge into two values, so the sweep's strict second
# forward crossing appears where f32 has none. Held: hit flips under 10%,
# the median ray within 2e-2 relative. Measured on the CPU twins, which
# the kernels equal bit for bit: flips 1.9-3.0% (4.8% on the second
# crossing), median 3.9e-3 to 5.2e-3.
ABLATE_BF16 = dict(flips=0.1, median_rel=2e-2)
# The bf16 matrix form against its twin: both take the same exact products
# of bf16 operands, the tensor core sums them in f32 with its own alignment
# and rounding, the twin in float64 rounded once. The sum's error, a few
# f32 ulps of its largest term, divides by det, so grazing pairs stray
# (measured by this phase on an H100 80GB HBM3 at 700 W, largest over all
# rays: mxu_hi3 4.8e-6 absolute, 1.7e-6 relative; mxu_lo 1.7e-3 absolute,
# 6.7e-4 relative, on one grazing ray).
# Held: phase 17's bounds on 99% of the rays that hit in both, every such
# ray within 1e-2 relative (under one bf16 rounding of the operands, 2^-8),
# hit flips under 2e-3, ids equal on 99.9%.
ABLATE_MXU_BF16 = dict(rtol=1e-6, atol=1e-6, share=0.99, max_rel=1e-2,
                       ids=0.999)

# K7 against its twin (phase 12). Both round the same bf16 operands; the
# tensor cores sum them in another order than cuBLAS, so a hidden
# activation's bf16 rounding flips now and then and carries to the outputs.
# Held: every output within K7_TOL_ALL of the largest (the presence logit,
# ~67 on sphere.json); every channel within K7_TOL of its own largest
# |value| (the logit would otherwise hide an error of ~1 in the distance,
# normal and colour channels, whose values stay below ~6); at most
# K7_SHARE of the rows with an output beyond 1e-5 x the largest.
# Measured on an H100 80GB HBM3 (700 W), the sound kernel on the march's
# slice and its two chunks: worst channel 0.042, 0.060, 0.037 of its own
# largest value (the twin itself lies 0.022 from float64 sums on the
# slice), 0.38-0.42% of the rows; planted faults (k7_planted): one warp's
# rows from another tile 1.51, neighbouring rows swapped 0.39 and all the
# rows.
K7_TOL_ALL = 2e-2
K7_TOL = 1e-1
K7_SHARE = 1e-2


def k7_errors(got, want):
    """K7's outputs [16, N] against its twin's: max |got - want| ("err")
    and its share of max |want| ("rel_all"), the worst channel ("channel")
    and its max |got - want| over its own largest |want| ("rel"), and the
    share of rows with an output beyond 1e-5 x max |want| ("share")."""
    import torch
    d = (got - want).abs()
    err, top = d.amax(dim=1), want.abs().amax(dim=1)
    rel = torch.where(top > 0, err / top,
                      torch.where(err > 0, float("inf"), 0.0))
    c = int(rel.argmax())
    e_all, top_all = err.max().item(), top.max().item()
    return dict(err=e_all, rel_all=(e_all / top_all if top_all > 0 else
                                    float("inf") if e_all > 0 else 0.0),
                channel=c, rel=rel[c].item(),
                share=(d > 1e-5 * top_all).any(dim=0).float().mean().item())


def k7_faults(e):
    """Why k7_errors' readings `e` fail phase 12's hold; empty when they
    hold."""
    faults = []
    if not e["rel_all"] <= K7_TOL_ALL:
        faults.append(f"off by {e['rel_all']!r} of the largest output")
    if not e["rel"] <= K7_TOL:
        faults.append(f"channel {e['channel']} off by {e['rel']!r} of its "
                      "largest value")
    if not e["share"] <= K7_SHARE:
        faults.append(f"{e['share']!r} of the rows beyond 1e-5 x max")
    return "; ".join(faults)


def k7_log(e):
    """k7_errors' readings as phase 12 logs them."""
    return (f"max difference {e['err']!r} ({e['rel_all']!r} of the "
            f"largest output), worst channel {e['channel']} off by "
            f"{e['rel']!r} of its largest value, share of rows beyond 1e-5 x "
            f"max {e['share']!r}")


def k7_summed(net, rows):
    """K7's function on `rows` [N, 112] with every product summed in
    float64 (the twin's bf16 operands and roundings, another summation
    order): [16, N] f32."""
    import torch
    from neural_renderer_tpu_torch.models import nbvh

    def bf16(v):
        return v.detach().to(torch.bfloat16).double()

    h = bf16(rows)
    for w in net.mlp[:-1]:
        h = bf16(torch.nn.functional.leaky_relu((h @ bf16(w).t()).float(),
                                                nbvh.LEAKY_SLOPE))
    return (h @ bf16(net.mlp[-1]).t()).float().t()


def k7_planted(out, tiles_apart):
    """Two faults planted in K7's output [16, N]: (a) one warp's 16 rows of
    a 64-row tile taken from the same rows `tiles_apart` tiles on (what a
    stage refilled while it is read yields: a block's tiles of one stage
    are two grids apart), (b) every two neighbouring rows swapped."""
    a = out.clone()
    src = 64 * tiles_apart
    a[:, 16:32] = out[:, src + 16:src + 32]
    n = out.shape[1] // 2 * 2
    b = out.clone()
    b[:, :n] = out[:, :n].reshape(16, -1, 2).flip(2).reshape(16, n)
    return {"stage refilled while read": a, "neighbouring rows swapped": b}


W, H, SPP, BOUNCES = 1920, 1080, 1, 3


def log(*a):
    print(*a, flush=True)


def sphere_json_segments(dev, width, height, n_slice):
    """configs/sphere/sphere.json's network (weights.bin) and the network
    inputs [12, N] of the first march iteration of its width x height
    neural frame (the camera fwd2 entry): `n_slice` live segments around
    the middle of the 1 spp frame, and every segment of the 8 spp batch
    (phase 14's pass). Returns (config, net, slice, live segments of the
    1 spp frame, batch)."""
    import torch
    from neural_renderer_tpu_torch import config as nr_config
    from neural_renderer_tpu_torch.render import pathtrace as pt
    from neural_renderer_tpu_torch.render.neural_march import (
        NeuralContext, _camera_fwd2_entry, segment_inputs)
    from neural_renderer_tpu_torch.render.renderer import (RenderBasis,
                                                           Renderer)
    from neural_renderer_tpu_torch.scene.scene import Scene
    cfg = nr_config.load_config(os.path.join(ROOT, "configs", "sphere",
                                             "sphere.json"))
    rend = Renderer(Scene.from_config(cfg), cfg.neural_network, device=dev)
    if not rend.load_weights_from_file(cfg.checkpoint_path):
        raise AssertionError("configs/sphere/weights.bin does not load")
    pos, yaw, pitch = nr_config.matrix_to_camera_state(cfg.camera.matrix)
    rend.set_camera_basis(RenderBasis(*nr_config.camera_basis_from_state(
        yaw, pitch, cfg.camera.yfov)))
    rend.resize(width, height)
    rend.set_bounce_count(cfg.rendering.bounce_count)
    ctx = NeuralContext(rend._mesh_tensors("outer_shell"),
                        rend._mesh_tensors("inner_shell"), rend.net)

    def first_iteration(spp):
        rend.set_samples_per_pixel(spp)
        params = rend._build_params(pos * cfg.original_mesh.scale, 0)
        _, _, _, orig, dirs = pt.primary_rays(params)
        entry, act, _, sw = _camera_fwd2_entry(ctx, orig, dirs)
        return segment_inputs(ctx, params, dirs, entry, act, sw=sw)[0], act

    x1, act = first_iteration(1)
    live = torch.nonzero(act).squeeze(1)
    first = max(0, live.numel() // 2 - n_slice // 2)
    x_slice = x1[:, live[first:first + n_slice]].contiguous()
    if x_slice.shape[1] != n_slice:
        raise AssertionError(f"only {live.numel()} live camera segments")
    del x1
    return cfg, rend.net, x_slice, live.numel(), first_iteration(8)[0]


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


def device_ms(fn, prefix, reps=10):
    """Device time in ms per fn() call of the kernels whose names contain
    `prefix` (torch.profiler, after one warm-up call), or None where the
    profiler saw none of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if prefix in e.key)
    return us / 1e3 / reps if us > 0 else None


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def pass_ms(fn, names, reps=5):
    """Device ms per call of fn() spent in each kernel whose name starts
    with one of `names` (torch.profiler over reps calls, after one
    warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    totals = [0.0] * len(names)
    for e in prof.key_averages():
        for i, name in enumerate(names):
            if e.key.startswith(name):
                totals[i] += e.self_device_time_total / 1e3 / reps
    return totals


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
    from neural_renderer_tpu_torch.ops import (bounds, cuda_build,
                                               fused_network,
                                               lane_grid_kernel,
                                               lane_grid_train_kernel,
                                               trace_cluster, trace_mxu,
                                               trace_pallas, traversal)
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

    # ---- the knot scene (phases 2 and 5-7) ------------------------------
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

    # ---- 2. kernels vs twins on the frame's inputs --------------------
    _, _, _, origins, dirs = pt.primary_rays(params)
    mid = (H // 2) * W - SLICE // 2
    o_s, d_s = origins[:, mid:mid + SLICE], dirs[:, mid:mid + SLICE]

    def counts_spread(counts):
        """The per-block cluster counts: min, mean, max and the share of
        blocks above 1.5 x the mean."""
        c = counts.float()
        mean = c.mean().item()
        return dict(count_min=int(counts.min()), count_mean=mean,
                    count_max=int(counts.max()),
                    share_above_1_5_mean=(c > 1.5 * mean).float().mean()
                    .item())

    k1_cases = {}   # label -> operands, fwd2 and the case's K1 numbers

    def sweep_case(ops, with_fwd2, label):
        """K1 against its twin on one case, bit-exact; time it (wrapper and
        device time) beside its bound on the block rule's pairs."""
        ker = trace_cluster.sweep_clusters_stream(*ops, with_fwd2=with_fwd2)
        twin = trace_cluster.sweep_clusters_twin(*ops, with_fwd2=with_fwd2)
        torch.cuda.synchronize()
        err = (ker - twin).abs().max().item()
        exact = torch.equal(ker, twin)
        log(f"[K1 {label}] rays {ops[0].shape[1]} max|kernel - twin| "
            f"{err!r} bit-exact {exact}")
        if not exact:
            raise AssertionError(f"K1 {label}: kernel != twin")

        def kernel():
            return trace_cluster.sweep_clusters_stream(*ops,
                                                       with_fwd2=with_fwd2)

        pairs = int(ops[4].sum().item()) * trace_cluster.CLUSTER_SIZE * 512
        case = dict(ms=time_ms(kernel), device_ms=device_ms(kernel,
                                                            "cluster"),
                    bound_ms=bounds.trace_seconds("local", pairs) * 1e3,
                    pairs=pairs, **counts_spread(ops[4]))
        log(f"[time K1 {label}] kernel {case['ms']:.4f} ms a wrapper call, "
            f"device {case['device_ms']!r} ms, bound {case['bound_ms']:.4f}"
            f" ms; clusters per block min {case['count_min']} mean "
            f"{case['count_mean']:.3f} max {case['count_max']}, share above "
            f"1.5x the mean {case['share_above_1_5_mean']:.4f}")
        k1_cases[label] = dict(ops=ops, fwd2=with_fwd2, k1=case)
        return err

    ops1 = traversal.clustered_sweep_operands(outer, inner, o_s, d_s)
    err1 = sweep_case(ops1, True, "camera fwd2 sweep")
    mxu_inputs = {"K1": ops1}   # phases 2, 5, 6's operands for phase 17
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
    err1 = max(err1, sweep_case(traversal.clustered_sweep_operands(
        outer, inner, rays.origin[:, bsel], rays.direction[:, bsel]), False,
        "bounce sweep"))
    # The knot's camera sweep: SLICE sorted camera rays around the middle
    # of those that meet the outer shell's box, against its shells (72
    # clusters).
    kouter = krend._mesh_tensors("outer_shell")
    kinner = krend._mesh_tensors("inner_shell")
    korder = traversal._ray_sort_order(korig, kdirs, None)
    ko, kd = korig[:, korder], kdirs[:, korder]
    inside = torch.nonzero(trace_cluster.mesh_exit_t(
        ko, kd, kouter.cluster_bounds, None) > 0).squeeze(1)
    kstart = max(0, min(ko.shape[1] - SLICE,
                        int(inside[inside.numel() // 2]) - SLICE // 2))
    kstart -= kstart % 512
    err1 = max(err1, sweep_case(traversal.clustered_sweep_operands(
        kouter, kinner, ko[:, kstart:kstart + SLICE].contiguous(),
        kd[:, kstart:kstart + SLICE].contiguous()), True,
        "knot camera fwd2 sweep"))
    del ko, kd, korder, inside

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
    mxu_inputs["K3"] = (o3, d3, tp3, bm3)
    fwd = traversal.FORWARD_ONLY
    case3 = dense_case(
        lambda: trace_pallas.trace_dense(o3, d3, tp3, fwd, bm3),
        lambda: twin3, (o3, d3, tp3, bm3), fwd, outer.num_triangles,
        smoke_times, fp32=True)
    block3 = first_live_block(o3, d3, bm3)
    case3_block = dense_case(
        lambda: trace_pallas.trace_dense(*block3[:2], tp3, fwd, block3[2]),
        lambda: trace_pallas.trace_dense_twin(*block3[:2], tp3, fwd,
                                              block3[2]),
        (*block3[:2], tp3, block3[2]), fwd, outer.num_triangles,
        smoke_times, fp32=True)
    log(f"[K3 outer FORWARD_ONLY] the slice: {case3}; its first live "
        f"512-ray block alone: {case3_block}")
    if not (case3["exact"] and case3_block["exact"]):
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
    cam1 = k1_cases["camera fwd2 sweep"]["k1"]
    pms1 = time_ms(lambda: trace_cluster.sweep_clusters_twin(*ops1,
                                                             with_fwd2=True),
                   reps=3)
    pairs1 = cam1["pairs"]
    bytes1 = nbytes(o1, d1, tp1, ids1, cnt1) + 5 * 4 * o1.shape[1]
    kernels["K1"] = dict(
        name="sweep_stream (clustered dual-shell sweep)", route="cuda",
        source="neural_renderer_tpu_torch/csrc/sweep_stream.cu",
        replaces="neural_renderer_tpu/ops/trace_cluster.py:443",
        max_abs_err=err1, ms=cam1["ms"], plain_ms=pms1,
        ops_seconds=bounds.trace_seconds("local", pairs1), bytes=bytes1,
        library_ms=None, device_ms=cam1["device_ms"],
        cases={k: {f: v for f, v in c["k1"].items() if f != "pairs"}
               for k, c in k1_cases.items()})

    pms3 = time_ms(lambda: trace_pallas.trace_dense_twin(
        o3, d3, tp3, traversal.FORWARD_ONLY, bm3), reps=3)
    # The bounds count the shell's real triangles, not the kernel's padding
    # of them to whole 512-triangle tiles.
    kernels["K3"] = dict(
        name="trace_dense (dense closest hit)", route="cuda",
        source="neural_renderer_tpu_torch/csrc/trace_dense.cu",
        replaces="neural_renderer_tpu/ops/trace_pallas.py:44",
        max_abs_err=err3, ms=case3["ms"], plain_ms=pms3,
        ops_seconds=case3["bound_ms"] * 1e-3,
        mt46_seconds=case3["mt46_bound_ms"] * 1e-3,
        bytes=nbytes(o3, d3, bm3) + 9 * 4 * outer.num_triangles
        + 2 * 4 * o3.shape[1], library_ms=None,
        device_ms=case3["device_ms"], cases={"one_block": case3_block})

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
    # Multiply-adds per row of the MLP, layer 0 at its real inputs: the
    # zero padding to 128 is the kernels' layout, not the function's work.
    macs = cfg.mlp_n_params
    kernels["K2"] = dict(
        name="lane_grid_forward (fused lane-grid network)", route="cuda",
        source="neural_renderer_tpu_torch/csrc/lane_grid_forward.cu",
        replaces="neural_renderer_tpu/ops/lane_grid_kernel.py:126",
        max_abs_err=err2, ms=ms2, plain_ms=pms2, ops=2 * macs * live2,
        bytes=nbytes(x_s, mask2, ops_k2.tables, ops_k2.w_hidden,
                     ops_k2.w_out) + 16 * 4 * SLICE,
        peak_ops=bounds.BF16_TENSOR, library_ms=lib2)
    for key in ("K1", "K2", "K3"):
        k = kernels[key]
        log(f"[time {key}] kernel {k['ms']:.4f} ms, twin "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}")
    # K2's split: K7 runs the same MLP on the tensor cores, so K7 on the
    # encoded features of the rows K2 computes (its live blocks) times the
    # MLP alone; the rest of K2's time is its encode.
    live_rows = torch.nonzero(torch.repeat_interleave(mask2 != 0, 128)) \
        .squeeze(1)
    rows2 = nbvh.encode_inputs(net, x_s[:, live_rows])
    img2 = fused_network.weight_image(net)
    mlp2 = time_ms(lambda: fused_network.launch(rows2, img2))
    log(f"[time K2 split] kernel {ms2:.4f} ms on {live2} live rows; MLP "
        f"alone (K7 on their encoded features) {mlp2:.4f} ms; encode and "
        f"the rest {ms2 - mlp2:.4f} ms")
    del rows2

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
    img, accum, default_mrays = run_frames(seeded_ctx, env, make_params,
                                           "seeded")
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
    default_trained = run_frames(ctx, env, make_params, "trained")[2]

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
        mxu_inputs[f"K5 {label}"] = (args, mode)

        def kernel():
            return trace_cluster.trace_clusters_stream(*args, mode)

        ms = time_ms(kernel)
        pms = time_ms(lambda: trace_cluster.trace_clusters_twin(*args, mode),
                      reps=2)
        ops_s, block_s = k5_items(f"K5 {label}", trace_cluster, bounds,
                                  args, mode, kt, ktri, swept_k, ms, kernel,
                                  mxu=False)
        entry = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, ops_seconds=ops_s,
            block_ops_seconds=block_s,
            bytes=nbytes(*args) + 2 * 4 * kt.shape[0], library_ms=None)
        log(f"[time K5 {label}] kernel {ms:.4f} ms, twin {pms:.4f} ms, "
            f"bound {entry['ops_seconds'] * 1e3:.4f} ms")
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
    mxu_inputs["K4"] = ops4
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
    real_tris4 = so.num_triangles + si.num_triangles
    o4, d4, tp4, cols4, bm4 = ops4
    case4 = dense_case(
        lambda: trace_pallas.sweep_shells_dense(o4, d4, tp4, cols4, True,
                                                bm4),
        lambda: trace_pallas.sweep_shells_dense_twin(o4, d4, tp4, cols4,
                                                     True, bm4),
        (o4, d4, tp4, bm4), 0, real_tris4, smoke_times, fp32=True)
    block4 = first_live_block(o4, d4, bm4)
    case4_block = dense_case(
        lambda: trace_pallas.sweep_shells_dense(*block4[:2], tp4, cols4,
                                                True, block4[2]),
        lambda: trace_pallas.sweep_shells_dense_twin(*block4[:2], tp4,
                                                     cols4, True, block4[2]),
        (*block4[:2], tp4, block4[2]), 0, real_tris4, smoke_times,
        fp32=True)
    log(f"[K4 camera sweep fwd2] the slice: {case4}; its first live 512-ray "
        f"block alone: {case4_block}")
    if not (case4["exact"] and case4_block["exact"]):
        raise AssertionError("K4: kernel != twin")
    pms4 = time_ms(lambda: trace_pallas.sweep_shells_dense_twin(
        *ops4[:4], True, ops4[4]), reps=3)
    kernels["K4"] = dict(
        name="sweep_dense (dense dual-shell sweep)", route="cuda",
        source="neural_renderer_tpu_torch/csrc/sweep_dense.cu",
        replaces="neural_renderer_tpu/ops/trace_pallas.py:95",
        max_abs_err=err4, ms=case4["ms"], plain_ms=pms4,
        ops_seconds=case4["bound_ms"] * 1e-3,
        mt46_seconds=case4["mt46_bound_ms"] * 1e-3,
        bytes=nbytes(ops4[0], ops4[1], ops4[4]) + 9 * 4 * real_tris4
        + 5 * 4 * SLICE, library_ms=None, device_ms=case4["device_ms"],
        cases={"one_block": case4_block})
    log(f"[time K4] kernel {case4['ms']:.4f} ms, twin {pms4:.4f} ms, bound "
        f"{case4['bound_ms']:.4f} ms (46 per pair: "
        f"{case4['mt46_bound_ms']:.4f})")

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
    knot7 = (psnr, flip)
    knot7_dir, knot7_text = out_dir, text
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
                   traversal, network=False):
        img_t = srend.render_accumulate([0.0, 0.0, 3.0], 2, batch_spp=1)
    with twin_path(lane_grid_kernel, trace_cluster, trace_pallas,
                   traversal):
        img_tn = srend.render_accumulate([0.0, 0.0, 3.0], 2, batch_spp=1)
    diff = abs(img_k.astype(int) - img_t.astype(int))
    diff_n = abs(img_k.astype(int) - img_tn.astype(int))
    frac8, mean8 = float((diff_n > 3).mean()), float(diff_n.mean())
    log(f"[small shells 480x270 kernels vs twins] K4 launches "
        f"{launches['K4']}; trace twins: identical "
        f"{bool((diff == 0).all())}, max |d| {int(diff.max())}; network "
        f"twin too: share > 3: {frac8!r}, mean |d| {mean8!r}; mean u8 "
        f"{img_k.mean():.3f}")
    if launches["K4"] <= 0:
        raise AssertionError("K4 was never launched on the small-shell path")
    if not (diff == 0).all() or img_k.std() < 1.0:
        raise AssertionError("small-shell kernel frame differs from the "
                             "trace twins' frame")
    if not (frac8 < 0.02 and mean8 < 1.0):
        raise AssertionError("small-shell kernel frame differs from the "
                             "twin frame")
    small_rend = srend

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
    split6 = pass_ms(lambda: ltk.backward_lane(knet, x9, g9),
                     ("lane_grid_backward_rays", "lane_grid_backward_dw"))
    log(f"[time K6 split] per-ray pass {split6[0]:.4f} ms, dW pass "
        f"{split6[1]:.4f} ms (torch.profiler, device time per launch)")
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
        + 2 * nbytes(ops_k6.tables) + 4 * macs,
        peak_ops=bounds.BF16_TENSOR, library_ms=lib6)
    log(f"[time K6] kernel {ms6:.4f} ms, twin {pms6:.4f} ms, library "
        f"{lib6:.4f} ms, bound "
        f"{3 * 2 * macs * n9 / bounds.BF16_TENSOR * 1e3:.4f} ms (operations)")
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
    fresh10, trained10 = first, l10.item()
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

    # ---- 12. K7 on the sphere.json network's segments ---------------------
    fm = fused_network
    sph_cfg_path = os.path.join(ROOT, "configs", "sphere", "sphere.json")
    scfg, snet, x12, n_live, x8 = sphere_json_segments(dev, W, H, SLICE)
    rows12 = nbvh.encode_inputs(snet, x12)
    ker7 = fm.fused_mlp(snet, rows12)
    twin7 = fm.apply_fused_twin(snet, rows12)
    torch.cuda.synchronize()

    faults7 = []

    def hold7(label, got, want):
        """Phase 12's hold of K7 (k7_faults, failing the phase at its end);
        returns max |got - want|."""
        e = k7_errors(got, want)
        each = (got - want).abs().amax(dim=1) / want.abs().amax(dim=1)
        log(f"[K7 {label}] rows {got.shape[1]}: {k7_log(e)}; each channel "
            f"{[float(f'{v:.3g}') for v in each.tolist()]}")
        if k7_faults(e):
            faults7.append(f"K7 {label}: {k7_faults(e)}")
        return e["err"]

    err7 = hold7(f"sphere.json march iteration 1 ({n_live} live)", ker7,
                 twin7)
    # How far the twin itself lies from float64 sums, beside the kernel.
    sum7 = k7_summed(snet, rows12)
    for label, got in (("twin", twin7), ("kernel", ker7)):
        log(f"[K7 {label} against float64 sums] "
            f"{k7_log(k7_errors(got, sum7))}")
    del sum7
    # The hold must reject a wrong kernel: it is shown two planted faults.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, bad in k7_planted(ker7, 2 * sms).items():
        e = k7_errors(bad, twin7)
        log(f"[K7 planted fault: {label}] {k7_log(e)}")
        if not k7_faults(e):
            faults7.append(f"K7's hold passes a planted fault: {label}")
    # The same bits on every call, on fresh copies of the rows (L2-hot, as
    # encode_inputs leaves them): the fault a stage released too early
    # leaves on some calls only.
    differ7 = sum(not torch.equal(fm.fused_mlp(snet, rows12.clone()), ker7)
                  for _ in range(10))
    log(f"[K7 repeatable] {differ7} of 10 calls on fresh copies differ from "
        "the first")
    if differ7:
        faults7.append("K7 gives other bits on some calls")
    macs7 = snet.config.mlp_n_params
    in7, out7 = 4 * snet.config.encoded_dims, 4 * fm.OUT_DIMS

    def bound7(rows):
        """K7's bound on `rows` rows (bounds.mlp_seconds) and what decides
        it."""
        b = bounds.mlp_seconds(rows, macs7, in7, out7)
        by = ("operations" if bounds.mlp_seconds(rows, macs7, 0, 0) >= b
              else "bytes")
        return b, by

    def time7(rows):
        """K7 on f32 rows: the wrapper (fused_mlp) by CUDA events, the
        kernel alone on the packed image, and the wrapper's device time."""
        img = fm.weight_image(snet)
        return (time_ms(lambda: fm.fused_mlp(snet, rows)),
                time_ms(lambda: fm.launch(rows, img)),
                device_ms(lambda: fm.fused_mlp(snet, rows), "fused_mlp"))

    ms7, kms7, dms7 = time7(rows12)
    pms7 = time_ms(lambda: fm.apply_fused_twin(snet, rows12), reps=3)
    # The library yardstick from the same f32 rows: a bf16 cast and the
    # torch.matmul + leaky_relu chain on the bf16 weights (never called by
    # the port).
    wts7 = [w.detach().to(torch.bfloat16) for w in snet.mlp]

    def chain7():
        h = rows12.to(torch.bfloat16)
        for w in wts7[:-1]:
            h = torch.nn.functional.leaky_relu(torch.matmul(h, w.t()),
                                               nbvh.LEAKY_SLOPE)
        return torch.matmul(h, wts7[-1].t())

    lib7 = time_ms(chain7)
    del ker7, twin7

    # The launch shapes of phase 14's 1080p x 8 pass: its march's iteration
    # 1 runs every ray of the batch, ENC_CHUNK rows a launch plus a tail.
    n8 = x8.shape[1]
    tail8 = n8 - (n8 - 1) // nbvh.ENC_CHUNK * nbvh.ENC_CHUNK
    cases7 = {}
    for label, lo, hi in (("first chunk", 0, nbvh.ENC_CHUNK),
                          ("last chunk", n8 - tail8, n8)):
        rows = nbvh.encode_inputs(snet, x8[:, lo:hi])
        k_out = fm.fused_mlp(snet, rows)
        t_out = fm.apply_fused_twin(snet, rows)
        err = hold7(f"sphere.json {W}x{H} x8 march iteration 1, {label} "
                    f"(of {n8})", k_out, t_out)
        err7 = max(err7, err)
        del k_out, t_out
        c_ms, c_kms, c_dms = time7(rows)
        c_b, c_by = bound7(hi - lo)
        cases7[label] = dict(rows=hi - lo, ms=c_ms, kernel_ms=c_kms,
                             device_ms=c_dms, bound_ms=c_b * 1e3,
                             bound_by=c_by)
        log(f"[time K7 {label}] {hi - lo} rows: wrapper {c_ms:.4f} ms, "
            f"kernel {c_kms:.4f} ms, device {c_dms} ms, bound "
            f"{c_b * 1e3:.4f} ms ({c_by})")
        del rows
    del x8
    if faults7:
        raise AssertionError("; ".join(faults7))
    b7, by7 = bound7(SLICE)
    kernels["K7"] = dict(
        name="fused_mlp (tcnn-layout fused MLP)", route="cuda",
        source="neural_renderer_tpu_torch/csrc/fused_mlp.cu",
        replaces="neural_renderer_tpu/ops/fused_network.py:41",
        max_abs_err=err7, ms=ms7, plain_ms=pms7,
        ops_seconds=bounds.mlp_seconds(SLICE, macs7, 0, 0),
        bytes=SLICE * (in7 + out7), library_ms=lib7, device_ms=dms7,
        cases=cases7)
    log(f"[time K7] {SLICE} rows: wrapper {ms7:.4f} ms, kernel {kms7:.4f} "
        f"ms, device {dms7} ms, twin {pms7:.4f} ms, library {lib7:.4f} ms, "
        f"bound {b7 * 1e3:.4f} ms ({by7}, bounds.mlp_seconds)")
    del rows12

    # ---- 13. evaluate on sphere.json -------------------------------------
    sout = os.path.join(ROOT, "comparison_output", "smoke_sphere")
    text = run_evaluate(evaluate, [sph_cfg_path, "--width", "480",
                                   "--height", "270", "--output", sout])
    psnr13, flip13 = parse_metrics(text)
    log(f"[evaluate sphere.json 480x270 x{scfg.rendering.total_samples}] "
        f"PSNR {psnr13!r} dB, FLIP {flip13!r} (gate >= 45.5 dB, <= 0.018)")
    if not (psnr13 >= 45.5 and flip13 <= 0.018):
        raise AssertionError("sphere.json evaluate misses the quality gate")

    # ---- 14. the same at 1080p x 8, counted ------------------------------
    all_counters["K7"] = fm.apply_fused
    for f in all_counters.values():
        f.launches = 0
    text = run_evaluate(evaluate, [
        sph_cfg_path, "--width", str(W), "--height", str(H),
        "--total-samples", "8", "--batch-spp", "8", "--output",
        sout + "_1080p"])
    eval14 = {k: f.launches for k, f in all_counters.items()}
    psnr14, flip14 = parse_metrics(text)
    rates = re.findall(r"(Ground truth|Neural): ([0-9.]+) Mrays/s", text)
    peaks = re.findall(r"(Ground truth|Neural): peak device memory (\d+) "
                       r"MiB", text)
    log(f"[evaluate sphere.json {W}x{H} x8, one batch of 8 spp] launches "
        f"{eval14}, Mrays/s {rates}, peak MiB {peaks}, PSNR {psnr14!r} dB, "
        f"FLIP {flip14!r}")
    if eval14["K7"] <= 0 or eval14["K2"] != 0:
        raise AssertionError("the sphere.json neural pass did not run "
                             "through K7")
    if not (psnr14 > 25.0 and flip14 < 0.1):
        raise AssertionError("1080p sphere.json evaluate is malformed")
    launches["K7"] = eval14["K7"]

    # ---- 15. flat FP16 blob round trip -----------------------------------
    blob_dir = os.path.join(ROOT, "comparison_output", "smoke_blob")
    os.makedirs(blob_dir, exist_ok=True)
    copy = os.path.join(blob_dir, "weights_copy.bin")
    nbvh.save_flat_blob(copy, nbvh.load_flat_blob(
        os.path.join(ROOT, "configs", "sphere", "weights.bin"), snet.config,
        device=dev))
    with open(copy, "rb") as f, open(os.path.join(
            ROOT, "configs", "sphere", "weights.bin"), "rb") as g:
        same = f.read() == g.read()
    log(f"[blob] weights.bin -> load_flat_blob -> save_flat_blob: "
        f"byte-identical {same}")
    if not same:
        raise AssertionError("save_flat_blob does not give weights.bin back")

    # ---- 16. training sphere.json (tcnn) ---------------------------------
    t0 = time.perf_counter()
    out_blob = os.path.join(blob_dir, "sphere_trained.bin")
    text = run_cli(train_cli.main, [
        sph_cfg_path, "--steps", "100", "--batch-size", "16384",
        "--segments-per-ray", "1", "--lr-schedule", "cosine",
        "--log-every", "1", "--ckpt-dir",
        os.path.join(blob_dir, "sphere_ckpt"), "--out", out_blob],
        keep=lambda ln: not re.match(r"step (\d+)/", ln) or
        int(re.match(r"step (\d+)/", ln).group(1)) % 10 in (0, 1))
    steps16 = re.findall(r"step (\d+)/100 loss=([0-9.]+).*\(([0-9.]+) "
                         r"Msegments/s\)", text)
    first, last = float(steps16[0][1]), float(steps16[-1][1])
    log(f"[train sphere.json 100 steps] {time.perf_counter() - t0:.2f} s, "
        f"loss {first!r} -> {last!r}, {steps16[-1][2]} Msegments/s")
    if not (len(steps16) == 100 and last <= 0.5 * first):
        raise AssertionError("tcnn training did not halve the loss in 100 "
                             "steps")
    if f"exported flat FP16 blob: {out_blob}" not in text:
        raise AssertionError("cli/train.py exported no blob")
    if not Renderer(Scene.from_config(scfg), scfg.neural_network,
                    device=dev).load_weights_from_file(out_blob):
        raise AssertionError("the exported blob does not load")
    text = run_evaluate(evaluate, [
        sph_cfg_path, "--width", "192", "--height", "108",
        "--total-samples", "8", "--ckpt", out_blob, "--output",
        os.path.join(blob_dir, "eval")])
    psnr16, flip16 = parse_metrics(text)
    log(f"[train sphere.json] exported blob through evaluate 192x108 x8: "
        f"PSNR {psnr16!r} dB, FLIP {flip16!r}")

    # ---- 17. the MXU kernels against twins and default kernels ----------
    def hold_rows(label, ker, twin, vpu, vpu_bounds=MXU_VPU):
        err = 0.0
        for row in range(ker.shape[0]):
            err = max(err, hold(f"{label} row {row} vs twin", ker[row],
                                twin[row], MXU_TWIN))
            hold(f"{label} row {row} vs default", ker[row], vpu[row],
                 vpu_bounds)
        return err

    def mxu_entry(name, source, replaces, err, ms, pms, vms, ops_s,
                  nbytes_):
        # ops_s: bounds.mxu_seconds of the pairs and the converted pairs.
        log(f"[time {name}] kernel {ms:.4f} ms, twin {pms:.4f} ms, default "
            f"kernel {vms:.4f} ms, bound {ops_s * 1e3:.4f} ms")
        return dict(name=name, route="cuda",
                    source="neural_renderer_tpu_torch/csrc/" + source,
                    replaces=replaces, max_abs_err=err, ms=ms, plain_ms=pms,
                    ops_seconds=ops_s, bytes=nbytes_, library_ms=None)

    t17 = time.perf_counter()
    fwd = traversal.FORWARD_ONLY
    o3, d3, tp3, bm3 = mxu_inputs["K3"]
    k8 = trace_mxu.trace_dense_mxu(o3, d3, tp3, fwd, bm3)
    t8 = trace_pallas.trace_dense_twin(o3, d3, tp3, fwd, bm3, mxu=True)
    v8 = trace_pallas.trace_dense(o3, d3, tp3, fwd, bm3, mxu=False)
    ids8 = [x[1].view(torch.int32) for x in (k8, t8, v8)]
    case8 = dense_case(
        lambda: trace_mxu.trace_dense_mxu(o3, d3, tp3, fwd, bm3), lambda: t8,
        (o3, d3, tp3, bm3), fwd, outer.num_triangles, smoke_times)
    log(f"[K8 outer FORWARD_ONLY] {case8}, t and ids bit-exact to the twin "
        f"{case8['exact']}")
    if not case8["exact"]:
        raise AssertionError("K8 outer FORWARD_ONLY: kernel != twin")
    err8 = hold("K8 outer FORWARD_ONLY vs twin", k8[0], t8[0], MXU_TWIN,
                ids8[0], ids8[1])
    hold("K8 outer FORWARD_ONLY vs K3", k8[0], v8[0], MXU_DENSE_VPU,
         ids8[0], ids8[2])
    kernels["K8"] = mxu_entry(
        "trace_dense_mxu (dense closest hit, matrix formulation)",
        "trace_dense_mxu.cu", "neural_renderer_tpu/ops/trace_mxu.py:112",
        err8, case8["ms"],
        time_ms(lambda: trace_pallas.trace_dense_twin(o3, d3, tp3, fwd, bm3,
                                                      mxu=True), reps=3),
        time_ms(lambda: trace_pallas.trace_dense(o3, d3, tp3, fwd, bm3,
                                                 mxu=False)),
        case8["bound_ms"] * 1e-3, kernels["K3"]["bytes"])
    kernels["K8"].update(cases={"e": case8}, device_ms=case8["device_ms"])

    # K1-MXU on phase 2's three sweeps: bit-exact to its twin, and within
    # the sweeps' bounds of K1 (on the knot, seen from distance 7, the
    # knot's bounds without ids: a sweep row has none).
    err1m = 0.0
    k1m_cases = {}
    for label, c in k1_cases.items():
        ops, fwd2 = c["ops"], c["fwd2"]
        ker = trace_cluster.sweep_clusters_stream_mxu(*ops, with_fwd2=fwd2)
        twin = trace_cluster.sweep_clusters_twin(*ops, fwd2, mxu=True)
        vpu = trace_cluster.sweep_clusters_stream(*ops, with_fwd2=fwd2,
                                                  mxu=False)
        torch.cuda.synchronize()
        exact = torch.equal(ker, twin)
        log(f"[K1-MXU {label}] every row bit-exact to the twin {exact}")
        if not exact:
            raise AssertionError(f"K1-MXU {label}: kernel != twin")
        err1m = max(err1m, hold_rows(
            f"K1-MXU {label}", ker, twin, vpu,
            dict(MXU_KNOT_VPU, t_same_id=False) if "knot" in label
            else MXU_VPU))

        def kernel_mxu():
            return trace_cluster.sweep_clusters_stream_mxu(
                *ops, with_fwd2=fwd2)

        # Every ray of a block sweeps the block's listed clusters.
        walks = ops[4][:, None].expand(
            -1, trace_cluster.BLOCK_RAYS // trace_cluster.ITEM_RAYS)
        converted = trace_cluster.epilogue_pairs(*ops[:4], walks)
        case = dict(ms=time_ms(kernel_mxu),
                    device_ms=device_ms(kernel_mxu, "cluster"),
                    epilogue_pairs=converted,
                    bound_ms=bounds.mxu_seconds(
                        c["k1"]["pairs"], converted=converted) * 1e3,
                    **counts_spread(ops[4]))
        log(f"[time K1-MXU {label}] kernel {case['ms']:.4f} ms a wrapper "
            f"call, device {case['device_ms']!r} ms, bound "
            f"{case['bound_ms']:.4f} ms; K1 {c['k1']['ms']:.4f} ms")
        k1m_cases[label] = case
    ops1 = mxu_inputs["K1"]
    cam1m = k1m_cases["camera fwd2 sweep"]
    kernels["K1-MXU"] = mxu_entry(
        "sweep_stream_mxu (clustered dual-shell sweep, matrix formulation)",
        "sweep_stream_mxu.cu", "neural_renderer_tpu/ops/trace_cluster.py:404",
        err1m, cam1m["ms"],
        time_ms(lambda: trace_cluster.sweep_clusters_twin(
            *ops1, True, mxu=True), reps=3),
        time_ms(lambda: trace_cluster.sweep_clusters_stream(
            *ops1, with_fwd2=True, mxu=False)),
        cam1m["bound_ms"] * 1e-3, bytes1)
    kernels["K1-MXU"].update(device_ms=cam1m["device_ms"], cases=k1m_cases)

    ops4 = mxu_inputs["K4"]
    for fwd2 in (True, False):
        exact = torch.equal(
            trace_pallas.sweep_shells_dense_mxu(*ops4[:4], fwd2, ops4[4]),
            trace_pallas.sweep_shells_dense_twin(*ops4[:4], fwd2, ops4[4],
                                                 mxu=True))
        log(f"[K4-MXU small-shell camera sweep fwd2={fwd2}] every row "
            f"bit-exact to the twin {exact}")
        if not exact:
            raise AssertionError(f"K4-MXU fwd2={fwd2}: kernel != twin")
    err4m = hold_rows(
        "K4-MXU small-shell camera sweep",
        trace_pallas.sweep_shells_dense_mxu(*ops4[:4], True, ops4[4]),
        trace_pallas.sweep_shells_dense_twin(*ops4[:4], True, ops4[4],
                                             mxu=True),
        trace_pallas.sweep_shells_dense(*ops4[:4], True, ops4[4],
                                        mxu=False))
    case4 = dense_case(
        lambda: trace_pallas.sweep_shells_dense_mxu(*ops4[:4], True, ops4[4]),
        lambda: trace_pallas.sweep_shells_dense_twin(*ops4[:4], True, ops4[4],
                                                     mxu=True),
        (*ops4[:3], ops4[4]), 0, real_tris4, smoke_times)
    kernels["K4-MXU"] = mxu_entry(
        "sweep_dense_mxu (dense dual-shell sweep, matrix formulation)",
        "sweep_dense_mxu.cu", "neural_renderer_tpu/ops/trace_pallas.py:201",
        err4m, case4["ms"],
        time_ms(lambda: trace_pallas.sweep_shells_dense_twin(
            *ops4[:4], True, ops4[4], mxu=True), reps=3),
        time_ms(lambda: trace_pallas.sweep_shells_dense(
            *ops4[:4], True, ops4[4], mxu=False)),
        case4["bound_ms"] * 1e-3, kernels["K4"]["bytes"])
    kernels["K4-MXU"].update(cases={"h": case4},
                             device_ms=case4["device_ms"])

    err5m = 0.0
    for label in ("knot camera", "knot bounce 1"):
        args, mode = mxu_inputs[f"K5 {label}"]
        swept = torch.zeros_like(args[5])
        kt, ktri = trace_cluster.trace_clusters_stream_mxu(*args, mode, True,
                                                           swept)
        vt, vtri = trace_cluster.trace_clusters_stream(*args, mode,
                                                       mxu=False)
        swept_t = torch.zeros_like(args[5])
        tt, ttri = trace_cluster.trace_clusters_twin(*args, mode, True,
                                                     swept_t, mxu=True)
        exact = (torch.equal(kt, tt) and torch.equal(ktri, ttri)
                 and torch.equal(swept, swept_t))
        log(f"[K5-MXU {label}] t, ids and swept bit-exact to the twin "
            f"{exact}")
        if not exact:
            raise AssertionError(f"K5-MXU {label}: kernel != twin")
        err5m = max(err5m, hold(f"K5-MXU {label} vs twin", kt, tt, MXU_TWIN,
                                ktri, ttri))
        hold(f"K5-MXU {label} vs K5", kt, vt, MXU_KNOT_VPU, ktri, vtri)

        def kernel_mxu():
            return trace_cluster.trace_clusters_stream_mxu(*args, mode)

        ms = time_ms(kernel_mxu)
        pms = time_ms(lambda: trace_cluster.trace_clusters_twin(
            *args, mode, mxu=True), reps=1)
        vms = time_ms(lambda: trace_cluster.trace_clusters_stream(
            *args, mode, mxu=False))
        ops_s, block_s = k5_items(f"K5-MXU {label}", trace_cluster,
                                  bounds, args, mode, kt, ktri, swept, ms,
                                  kernel_mxu, mxu=True)
        entry = mxu_entry(
            "trace_cluster_stream_mxu (clustered closest hit, matrix "
            "formulation)", "trace_cluster_stream_mxu.cu",
            "neural_renderer_tpu/ops/trace_cluster.py:169", err5m, ms, pms,
            vms, ops_s, nbytes(*args) + 2 * 4 * kt.shape[0])
        entry["block_ops_seconds"] = block_s
        if label == "knot camera":
            kernels["K5-MXU"] = entry
    kernels["K5-MXU"]["max_abs_err"] = err5m
    log(f"[phase 17] {time.perf_counter() - t17:.1f} s")

    # ---- 18. the sphere frame with NR_TRACE_MXU=1 ---------------------------
    t18 = time.perf_counter()
    mxu_counters = {"K1": trace_cluster.sweep_clusters_stream,
                    "K3": trace_pallas.trace_dense,
                    "K4": trace_pallas.sweep_shells_dense,
                    "K5": trace_cluster.trace_clusters_stream,
                    "K8": trace_mxu.trace_dense_mxu,
                    "K1-MXU": trace_cluster.sweep_clusters_stream_mxu,
                    "K4-MXU": trace_pallas.sweep_shells_dense_mxu,
                    "K5-MXU": trace_cluster.trace_clusters_stream_mxu}
    saved_env = os.environ.get("NR_TRACE_MXU")
    os.environ["NR_TRACE_MXU"] = "1"
    try:
        img_k, _ = neural_frame.render_neural_frame(
            ctx, env, p_small, torch.zeros((3, 480 * 270), device=dev))
        with twin_path(lane_grid_kernel, trace_cluster, trace_pallas,
                       traversal):
            img_t, _ = neural_frame.render_neural_frame(
                ctx, env, p_small, torch.zeros((3, 480 * 270), device=dev))
        diff = (img_k.to(torch.int32) - img_t.to(torch.int32)).abs().float()
        frac18, mean18 = (diff > 3).float().mean().item(), diff.mean().item()
        log(f"[MXU frame 480x270 kernels vs twins] share > 3: {frac18!r}, "
            f"mean |d| {mean18!r}")
        if not (frac18 < 0.02 and mean18 < 1.0):
            raise AssertionError("480x270 MXU kernel frame differs from the "
                                 "twin frame")
        # The frame's own K8 launches (the FP-grazing re-entry retraces),
        # recorded in an untimed frame like run_frames' warm-up, for case
        # (f) of the kernels line.
        with recording_dense(traversal, trace_mxu) as k8_calls:
            neural_frame.render_neural_frame(
                seeded_ctx, env, make_params(W, H),
                torch.zeros((3, W * H), device=dev))
        for f in mxu_counters.values():
            f.launches = 0
        img, accum, mxu_mrays = run_frames(seeded_ctx, env, make_params,
                                           "seeded, NR_TRACE_MXU=1")
        frame18 = {k: f.launches for k, f in mxu_counters.items()}
        log(f"[MXU frame {W}x{H} seeded] launches over 3 frames {frame18}")
        if img.shape != (H, W, 3) or not torch.isfinite(accum).all():
            raise AssertionError("full-size MXU frame is malformed")
        if not (frame18["K1-MXU"] > 0 and frame18["K8"] > 0
                and frame18["K1"] == 0 and frame18["K3"] == 0):
            raise AssertionError("the MXU frame did not run through K1-MXU "
                                 "and K8 alone")
        launches["K8"] = frame18["K8"]
        launches["K1-MXU"] = frame18["K1-MXU"]
        if not k8_calls:
            raise AssertionError("the recorded MXU frame made no K8 call")
        kernels["K8"]["cases"]["f"] = []
        for i, (o, d, tp, mode, mask) in enumerate(k8_calls):
            case = dense_case(
                lambda: trace_mxu.trace_dense_mxu(o, d, tp, mode, mask),
                lambda: trace_pallas.trace_dense_twin(o, d, tp, mode, mask,
                                                      mxu=True),
                (o, d, tp, mask), mode, outer.num_triangles, smoke_times)
            log(f"[K8 frame launch {i}] {case}")
            if not case["exact"]:
                raise AssertionError(f"K8 frame launch {i}: kernel != twin")
            kernels["K8"]["cases"]["f"].append(case)
        del k8_calls
        mxu_trained = run_frames(ctx, env, make_params,
                                 "trained, NR_TRACE_MXU=1")[2]
        log(f"[MXU frame {W}x{H}] Mrays/s seeded {mxu_mrays!r} (default "
            f"{default_mrays!r}), trained {mxu_trained!r} (default "
            f"{default_trained!r})")
        log(f"[phase 18] {time.perf_counter() - t18:.1f} s")

        # ---- 19. knot evaluate and small shells with NR_TRACE_MXU=1 -------
        t19 = time.perf_counter()
        for f in mxu_counters.values():
            f.launches = 0
        text = run_evaluate(evaluate, [
            knot_cfg_path, "--width", "480", "--height", "270", "--output",
            out_dir + "_mxu"])
        eval19 = {k: f.launches for k, f in mxu_counters.items()}
        psnr19, flip19 = parse_metrics(text)
        log(f"[MXU evaluate knot 480x270 x{kcfg.rendering.total_samples}] "
            f"PSNR {psnr19!r} dB, FLIP {flip19!r} (gate >= 40.2 dB, <= "
            f"0.018), launches {eval19}")
        if not (psnr19 >= 40.2 and flip19 <= 0.018):
            raise AssertionError("MXU knot evaluate misses the quality gate")
        if not (eval19["K5-MXU"] > 0 and eval19["K1-MXU"] > 0
                and eval19["K5"] == 0 and eval19["K1"] == 0):
            raise AssertionError("the MXU evaluate did not run through "
                                 "K5-MXU and K1-MXU alone")
        launches["K5-MXU"] = eval19["K5-MXU"]

        trace_pallas.sweep_shells_dense_mxu.launches = 0
        img_k = small_rend.render_accumulate([0.0, 0.0, 3.0], 2, batch_spp=1)
        launches["K4-MXU"] = trace_pallas.sweep_shells_dense_mxu.launches
        with twin_path(lane_grid_kernel, trace_cluster, trace_pallas,
                       traversal):
            img_t = small_rend.render_accumulate([0.0, 0.0, 3.0], 2,
                                                 batch_spp=1)
        diff = abs(img_k.astype(int) - img_t.astype(int))
        frac19, mean19 = float((diff > 3).mean()), float(diff.mean())
        log(f"[MXU small shells 480x270 kernels vs twins] K4-MXU launches "
            f"{launches['K4-MXU']}, share > 3: {frac19!r}, mean |d| "
            f"{mean19!r}, mean u8 {img_k.mean():.3f}")
        if launches["K4-MXU"] <= 0:
            raise AssertionError("K4-MXU was never launched on the "
                                 "small-shell path")
        if not (frac19 < 0.02 and mean19 < 1.0) or img_k.std() < 1.0:
            raise AssertionError("small-shell MXU kernel frame differs from "
                                 "the twin frame")
        log(f"[phase 19] {time.perf_counter() - t19:.1f} s")
    finally:
        if saved_env is None:
            os.environ.pop("NR_TRACE_MXU", None)
        else:
            os.environ["NR_TRACE_MXU"] = saved_env

    # ---- 20. the trace-kernel ablation (K9) -------------------------------
    t20 = time.perf_counter()
    ablation_phase(kernels, launches)
    log(f"[phase 20] {time.perf_counter() - t20:.1f} s")

    # ---- 21. the lane sphere's gate and the bench entry -------------------
    t21 = time.perf_counter()
    lane_cfg = os.path.join(ROOT, "configs", "sphere", "sphere_lane.json")
    text = run_evaluate(evaluate, [
        lane_cfg, "--width", "480", "--height", "270", "--output",
        os.path.join(ROOT, "comparison_output", "smoke_sphere_lane")])
    psnr21, flip21 = parse_metrics(text)
    log(f"[evaluate sphere_lane.json 480x270 x64] PSNR {psnr21!r} dB, FLIP "
        f"{flip21!r} (gate >= 50.54 dB, <= 0.018)")
    if not (psnr21 >= 50.54 and flip21 <= 0.018):
        raise AssertionError("sphere_lane.json evaluate misses the quality "
                             "gate")
    bench = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py")],
        env=dict(os.environ, BENCH_SKIP_CPU="1"), capture_output=True,
        text=True, timeout=600)
    line = (bench.stdout.strip().splitlines() or [""])[-1]
    log(f"[bench_torch.py] rc {bench.returncode}: {line}")
    result = json.loads(line) if bench.returncode == 0 else {}
    if not (set(result) == BENCH_KEYS and "(cuda)" in result["metric"]
            and 0 < result["min"] <= result["value"] <= result["max"]):
        raise AssertionError("bench_torch.py printed no bench.py line: "
                             f"{bench.stderr[-500:]}")
    log(f"[phase 21] {time.perf_counter() - t21:.1f} s")

    # ---- 22. the studio scene ---------------------------------------------
    t22 = time.perf_counter()
    studio22 = studio_phase(kernels, smi)
    log(f"[phase 22] {time.perf_counter() - t22:.1f} s")

    # ---- 23. every scene and image format ---------------------------------
    t23 = time.perf_counter()
    formats_phase(knot7)
    log(f"[phase 23] {time.perf_counter() - t23:.1f} s")

    # ---- 24. the viewer -----------------------------------------------------
    t24 = time.perf_counter()
    viewer_phase(smi)
    log(f"[phase 24] {time.perf_counter() - t24:.1f} s")

    # ---- 25. the multi-GPU paths -------------------------------------------
    t25 = time.perf_counter()
    parallel_phase(smi, knot7_dir, knot7_text, fresh_loss=fresh10,
                   trained_loss=trained10)
    log(f"[phase 25] {time.perf_counter() - t25:.1f} s")

    # ---- 26. the networks the port trained -------------------------------
    t26 = time.perf_counter()
    trained_phase(smi, {"knot": knot7, "sphere": (psnr13, flip13),
                        "studio": (studio22["psnr"], studio22["flip"])})
    log(f"[phase 26] {time.perf_counter() - t26:.1f} s")

    out = []
    for key in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K1-MXU",
                "K4-MXU", "K5-MXU", *(k for k in kernels
                                      if k.startswith("K9"))):
        k = kernels[key]
        t_ops = (k.pop("ops_seconds") if "ops_seconds" in k
                 else k.pop("ops") / k.pop("peak_ops"))
        t_bytes = k.pop("bytes") / bounds.BYTES_RATE
        k["bound_ms"] = max(t_ops, t_bytes) * 1e3
        k["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        k["launches"] = launches[key]
        out.append({f: k[f] for f in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        if "cases" in k:
            # K1, K1-MXU, the dense kernels and K7: the device time of the
            # wrapper's kernels, and every case's time and bound (K1's with
            # its per-block cluster counts, K7's ENC_CHUNK launches).
            out[-1].update(device_ms=k["device_ms"], cases=k["cases"])
        if "mt46_seconds" in k:
            # K3, K4: bound_ms counts the pairs their prefilter leaves; this
            # one Möller–Trumbore's 46 operations on every pair.
            out[-1]["mt46_bound_ms"] = max(k.pop("mt46_seconds"),
                                           t_bytes) * 1e3
        if "block_ops_seconds" in k:
            # K5, K5-MXU: bound_ms counts the pairs their items swept; this
            # one the block rule's, the TPU kernel's walk.
            out[-1]["block_rule_bound_ms"] = max(
                k.pop("block_ops_seconds"), t_bytes) * 1e3
        if "pair_ops_seconds" in k:
            # K9's prefiltered kernels: bound_ms counts the pairs their rule
            # leaves; this one every pair, and the share the rule leaves.
            out[-1]["per_pair_bound_ms"] = max(
                k.pop("pair_ops_seconds"), t_bytes) * 1e3
            out[-1]["survivors"] = k["survivors"]
        if "studio" in k:
            # K2, K3, K4 at the studio scene's launch shapes (phase 22).
            out[-1]["studio"] = k["studio"]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


STUDIO_GATE = dict(psnr=23.5, flip=0.065)   # tests/test_golden.py:150-174


def studio_case(fn, twin, operands, mode, real_tris, rows):
    """dense_case of a K3 or K4 launch of the studio scene, with the
    twin's time, the bytes the call moves (rays, skip flags and triangles
    read once, `rows` f32 rows a ray written once) and the bound the
    larger of the prefilter's operations and those bytes."""
    from neural_renderer_tpu_torch.ops import bounds
    case = dense_case(fn, twin, operands, mode, real_tris, smoke_times,
                      fp32=True)
    case["plain_ms"] = time_ms(twin, reps=3)
    o, d, _, mask = operands
    t_bytes = (nbytes(o, d, mask) + 9 * 4 * real_tris
               + rows * 4 * o.shape[1]) / bounds.BYTES_RATE * 1e3
    case["ops_bound_ms"] = case["bound_ms"]
    case["bound_by"] = "operations" if case["bound_ms"] >= t_bytes \
        else "bytes"
    case["bound_ms"] = max(case["bound_ms"], t_bytes)
    return case


@contextlib.contextmanager
def pass_launches(counters):
    """Record, for each Renderer.render_accumulate call made in the block
    (one `evaluate` pass), the launches each counter took during it: yields
    a dict "gt" / "neural" -> {kernel: launches}."""
    from neural_renderer_tpu_torch.render.renderer import Renderer
    real = Renderer.render_accumulate
    passes = {}

    def counted(self, *a, **kw):
        before = {k: f.launches for k, f in counters.items()}
        try:
            return real(self, *a, **kw)
        finally:
            passes["neural" if self.use_neural_query else "gt"] = {
                k: f.launches - before[k] for k, f in counters.items()}

    Renderer.render_accumulate = counted
    try:
        yield passes
    finally:
        Renderer.render_accumulate = real


def studio_phase(kernels, smi, dev="cuda"):
    """Phase 22: the studio scene (see the module docstring)."""
    import torch
    from neural_renderer_tpu_torch import config as nr_config
    from neural_renderer_tpu_torch.cli import evaluate
    from neural_renderer_tpu_torch.ops import (bounds, lane_grid_kernel,
                                               trace_cluster, trace_pallas,
                                               traversal)
    from neural_renderer_tpu_torch.render import neural_frame
    from neural_renderer_tpu_torch.render import pathtrace as pt
    from neural_renderer_tpu_torch.render.neural_march import (
        NeuralContext, _camera_fwd2_entry, segment_inputs)
    from neural_renderer_tpu_torch.render.renderer import (RenderBasis,
                                                           Renderer)
    from neural_renderer_tpu_torch.scene.scene import Scene
    dev = torch.device(dev)
    cfg_path = os.path.join(ROOT, "configs", "studio", "studio_lane.json")
    cfg = nr_config.load_config(cfg_path)

    # (a) the scene
    t0 = time.perf_counter()
    scene = Scene.from_config(cfg)
    rend = Renderer(scene, cfg.neural_network, device=dev)
    if not rend.load_weights_from_file(cfg.checkpoint_path):
        raise AssertionError("the studio weights do not load")
    gt_mesh = rend._mesh_tensors("original_mesh")
    outer = rend._mesh_tensors("outer_shell")
    inner = rend._mesh_tensors("inner_shell")
    extra = rend._mesh_tensors("additional_mesh")
    env = rend._env_tensors()
    log(f"[studio] loaded in {time.perf_counter() - t0:.2f} s: sky "
        f"{env.width}x{env.height} valid {env.is_valid}, torus "
        f"{gt_mesh.num_triangles} triangles (textures "
        f"{gt_mesh.has_textures}, normal maps {gt_mesh.has_normal_maps}), "
        f"shells {outer.num_triangles} + {inner.num_triangles}, extra "
        f"{extra.num_triangles}")
    if not ((env.width, env.height, env.is_valid) == (256, 128, True)
            and scene.environment_error is None and not scene.failed_meshes
            and gt_mesh.has_textures and gt_mesh.has_normal_maps):
        raise AssertionError("the studio scene did not load whole")
    pos, yaw, pitch = nr_config.matrix_to_camera_state(cfg.camera.matrix)
    rend.set_camera_basis(RenderBasis(*nr_config.camera_basis_from_state(
        yaw, pitch, cfg.camera.yfov)))
    rend.set_bounce_count(cfg.rendering.bounce_count)
    rend.resize(W, H)
    params = rend._build_params(pos, 0)
    pix, samp, _, origins, dirs = pt.primary_rays(params)

    # (b) K4, K3 and K2 at the scene's launch shapes
    inside = torch.nonzero(trace_cluster.mesh_exit_t(
        origins, dirs, outer.cluster_bounds, None) > 0).squeeze(1)
    start = max(0, min(origins.shape[1] - SLICE,
                       int(inside[inside.numel() // 2]) - SLICE // 2))
    start -= start % 512
    o_s = origins[:, start:start + SLICE].contiguous()
    d_s = dirs[:, start:start + SLICE].contiguous()
    ops4 = traversal.dense_sweep_operands(outer, inner, o_s, d_s)
    o4, d4, tp4, cols4, bm4 = ops4
    real4 = outer.num_triangles + inner.num_triangles
    cases4 = {}
    for fwd2 in (True, False):
        cases4[f"camera fwd2={fwd2}"] = studio_case(
            lambda: trace_pallas.sweep_shells_dense(o4, d4, tp4, cols4,
                                                    fwd2, bm4),
            lambda: trace_pallas.sweep_shells_dense_twin(o4, d4, tp4, cols4,
                                                         fwd2, bm4),
            (o4, d4, tp4, bm4), 0, real4, 5 if fwd2 else 4)
    log(f"[studio K4 camera sweep] rays {SLICE}, live blocks "
        f"{int(bm4.sum())} of {bm4.numel()}: {cases4}")
    if not all(c["exact"] for c in cases4.values()):
        raise AssertionError("studio K4: kernel != twin")

    fwd, anym = traversal.FORWARD_ONLY, traversal.ANY

    def k3_case(mesh, o, d, mode, active=None):
        o3, d3, tp3, bm3 = traversal.dense_trace_operands(mesh, o, d,
                                                          active)
        return (o3, d3, tp3, bm3), studio_case(
            lambda: trace_pallas.trace_dense(o3, d3, tp3, mode, bm3),
            lambda: trace_pallas.trace_dense_twin(o3, d3, tp3, mode, bm3),
            (o3, d3, tp3, bm3), mode, mesh.num_triangles, 2)

    torus_ops, torus = k3_case(gt_mesh, o_s, d_s, fwd)
    block = first_live_block(torus_ops[0], torus_ops[1], torus_ops[3])
    _, torus_block = k3_case(gt_mesh, block[0], block[1], fwd)
    # extra.obj's first bounce rays: the hybrid camera hits (the march
    # merged with extra.obj's FORWARD_ONLY hits), sampled, the active ones
    # in the bounce stage's compaction order.
    ctx = NeuralContext(outer, inner, rend.net)
    hits = neural_frame.trace_neural_segments(ctx, params, origins, dirs)
    hits = pt.select_closest_hits(params, hits, pt.trace_rays_mesh(
        extra, params, origins, dirs, fwd), origins)
    rays = pt.sample_bounce_directions(params, pix, samp, hits, hits.hit,
                                       None)
    act = torch.nonzero(hits.hit & (rays.pdf > 0)).squeeze(1)
    order = traversal._ray_sort_order(rays.origin[:, act],
                                      rays.direction[:, act])
    sel = act[order][:SLICE]
    _, bounce = k3_case(extra, rays.origin[:, sel].contiguous(),
                        rays.direction[:, sel].contiguous(), anym)
    cases3 = {"torus FORWARD_ONLY": torus,
              "torus first live block": torus_block,
              "extra.obj bounce 1 ANY": bounce}
    log(f"[studio K3] {cases3}")
    if not all(c["exact"] for c in cases3.values()):
        raise AssertionError("studio K3: kernel != twin")

    entry_pos, active, _, sw1 = _camera_fwd2_entry(ctx, origins, dirs)
    net_in = segment_inputs(ctx, params, dirs, entry_pos, active, sw=sw1)[0]
    x_s = net_in[:, start:start + SLICE].contiguous()
    a_s = active[start:start + SLICE]
    mask2 = lane_grid_kernel._block_mask(a_s, SLICE, dev)
    ker2 = lane_grid_kernel.forward_lane(rend.net, x_s, active=a_s)
    twin2 = lane_grid_kernel.forward_lane_twin(rend.net, x_s, mask2)
    rel2 = ((ker2 - twin2).abs().max() / twin2.abs().max()).item()
    case2 = dict(
        rays=SLICE, live=int(mask2.sum()) * 128, max_rel_err=rel2,
        ms=time_ms(lambda: lane_grid_kernel.forward_lane(rend.net, x_s,
                                                         active=a_s)),
        plain_ms=time_ms(lambda: lane_grid_kernel.forward_lane_twin(
            rend.net, x_s, mask2), reps=3))
    # Bound as phase 2's K2: the MLP's multiply-adds on the live rows, or
    # the rows, tables and weights read and the outputs written.
    ops2 = lane_grid_kernel._operands(rend.net)
    t_ops = 2 * rend.net_config.mlp_n_params * case2["live"] \
        / bounds.BF16_TENSOR
    t_bytes = (nbytes(x_s, mask2, ops2.tables, ops2.w_hidden, ops2.w_out)
               + 16 * 4 * SLICE) / bounds.BYTES_RATE
    case2.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"[studio K2 march iteration 1] {case2}")
    if not rel2 < 2e-2:
        raise AssertionError(f"studio K2: relative error {rel2} >= 2e-2")
    del hits, rays, net_in, ker2, twin2

    # (c) 480x270 frames, kernels against twins on the card
    rend.resize(480, 270)
    frames = {}
    for label, neural in (("ground truth", False), ("hybrid neural", True)):
        rend.set_use_neural_query(neural)
        img_k = rend.render_accumulate(pos, 2, batch_spp=1)
        with twin_path(lane_grid_kernel, trace_cluster, trace_pallas,
                       traversal):
            img_t = rend.render_accumulate(pos, 2, batch_spp=1)
        diff = abs(img_k.astype(int) - img_t.astype(int))
        frames[label] = dict(share_above_3=float((diff > 3).mean()),
                             mean=float(diff.mean()), max=int(diff.max()),
                             mean_u8=float(img_k.mean()))
        if not (frames[label]["share_above_3"] < 0.02
                and frames[label]["mean"] < 1.0 and img_k.std() > 1.0):
            raise AssertionError(f"studio {label} kernel frame differs "
                                 "from the twin frame")
    log(f"[studio 480x270 kernels vs twins] {frames}")

    # (d) the JAX gate without the additional mesh, (e) the hybrid run
    counters = {
        "K1": trace_cluster.sweep_clusters_stream,
        "K2": lane_grid_kernel.forward_lane, "K3": trace_pallas.trace_dense,
        "K4": trace_pallas.sweep_shells_dense,
        "K5": trace_cluster.trace_clusters_stream}
    out_dir = os.path.join(ROOT, "comparison_output", "smoke_studio")
    studio = {}
    for label, extra_args in (("no additional", ["--no-additional"]),
                              ("hybrid", [])):
        for f in counters.values():
            f.launches = 0
        with pass_launches(counters) as passes:
            text = run_evaluate(evaluate, [
                cfg_path, "--width", "480", "--height", "270", "--output",
                f"{out_dir}_{label.replace(' ', '_')}", *extra_args])
        psnr, flip = parse_metrics(text)
        studio[label] = dict(psnr=psnr, flip=flip, launches=passes)
        log(f"[evaluate studio {label} 480x270 x"
            f"{cfg.rendering.total_samples}] PSNR {psnr!r} dB, FLIP "
            f"{flip!r}, launches per pass {passes}")
    gate = studio["no additional"]
    if not (gate["psnr"] >= STUDIO_GATE["psnr"]
            and gate["flip"] <= STUDIO_GATE["flip"]):
        raise AssertionError(f"studio evaluate misses the quality gate "
                             f"{STUDIO_GATE}")
    for label in studio:
        p = studio[label]["launches"]
        if set(p) != {"gt", "neural"} or any(
                p[s][k] != 0 for s in p for k in ("K1", "K5")):
            raise AssertionError(f"studio {label}: a clustered kernel "
                                 f"launched or a pass is missing: {p}")
    p = gate["launches"]
    if not (p["gt"]["K3"] > 0 and p["neural"]["K4"] > 0
            and p["neural"]["K2"] > 0):
        raise AssertionError(f"studio evaluate did not run through K3, K4 "
                             f"and K2: {p}")
    if not studio["hybrid"]["launches"]["neural"]["K3"] > 0:
        raise AssertionError("the hybrid neural pass never launched K3")

    # (f) 1080p x 8 in one batch
    text = run_evaluate(evaluate, [
        cfg_path, "--width", str(W), "--height", str(H), "--total-samples",
        "8", "--batch-spp", "8", "--output", f"{out_dir}_1080p"])
    rates = re.findall(r"(Ground truth|Neural): ([0-9.]+) Mrays/s", text)
    peaks = re.findall(r"(Ground truth|Neural): peak device memory (\d+) "
                       r"MiB", text)
    psnr8, flip8 = parse_metrics(text)
    log(f"[evaluate studio hybrid {W}x{H} x8, one batch of 8 spp] "
        f"Mrays/s {rates}, peak MiB {peaks}, PSNR {psnr8!r} dB, FLIP "
        f"{flip8!r} ({smi})")
    if len(rates) != 2 or len(peaks) != 2 * (dev.type == "cuda"):
        raise AssertionError("the 1080p studio evaluate printed no speed")

    kernels["K4"]["studio"] = dict(cases4, launches=gate["launches"])
    kernels["K3"]["studio"] = dict(cases3, launches={
        k: v["launches"] for k, v in studio.items()})
    kernels["K2"]["studio"] = dict(march_iteration_1=case2,
                                   launches=gate["launches"])
    return gate



KNOT_GATE = dict(psnr=40.2, flip=0.018)      # phase 7's gate

# Phase 26: each committed network the port trained from scratch, its
# config, the evaluate flags of the phase that gates the JAX-trained
# weights, and that gate.
TRAINED_GATES = {
    "studio": ("configs/studio/studio_lane.json",
               "configs/studio/torch_lane_step12000.npz",
               ["--no-additional"], STUDIO_GATE),
    "sphere": ("configs/sphere/sphere.json",
               "configs/sphere/torch_weights.bin", [],
               dict(psnr=45.5, flip=0.018)),                # phase 13
    "knot": ("configs/knot/knot_lane.json",
             "configs/knot/torch_lane_step48000.npz", [], KNOT_GATE),
}
# The studio recipe cut to 500 steps, on an NVIDIA H100 80GB HBM3 at 700 W:
# sound runs ended at 0.1727-0.1751 (five runs, seeds 0 and 1); a run
# that learned nothing after its step 200 would end near the sound runs'
# step-200 loss, 0.2143-0.2149. Planted faults (measurements, not in the
# code): the learning rate / 10 ended at 0.8194, the K2/K6 operand cache
# frozen after step 133 at 0.3285.
STUDIO500_LOSS = 0.19
FORMATS_STUDIO_SKIES = (("jpeg", "studio_sky_baseline.jpg"),
                        ("dwab", "dwab_reference.exr"))


def trained_phase(smi, jax_scores, dev="cuda", size=(480, 270),
                  total_samples=None, steps=500, batch=65536):
    """Phase 26: the port-trained networks' gates, then the cut studio
    recipe through cli/train.py with its launches counted."""
    from neural_renderer_tpu_torch.cli import evaluate
    from neural_renderer_tpu_torch.cli import train as train_cli
    from neural_renderer_tpu_torch.ops import (lane_grid_kernel,
                                               lane_grid_train_kernel,
                                               trace_pallas)
    w, h = size
    extra = ["--total-samples", str(total_samples)] if total_samples else []
    for scene, (cfg, weights, flags, gate) in TRAINED_GATES.items():
        t0 = time.perf_counter()
        text = run_evaluate(evaluate, [
            os.path.join(ROOT, cfg), "--width", str(w), "--height", str(h),
            *flags, *extra, "--ckpt", os.path.join(ROOT, weights),
            "--device", dev, "--output", os.path.join(
                ROOT, "comparison_output", f"smoke_trained_{scene}")])
        psnr, flip = parse_metrics(text)
        jp, jf = jax_scores[scene]
        log(f"[evaluate {scene} {w}x{h}, port-trained {weights}] PSNR "
            f"{psnr!r} dB, FLIP {flip!r} (JAX-trained weights {jp!r} dB, "
            f"{jf!r}; gate >= {gate['psnr']} dB, <= {gate['flip']}) "
            f"{time.perf_counter() - t0:.1f} s ({smi})")
        if not (psnr >= gate["psnr"] and flip <= gate["flip"]):
            raise AssertionError(f"the port-trained {weights} misses its "
                                 f"gate {gate}")

    counters = {"K2": lane_grid_kernel.forward_lane,
                "K3": trace_pallas.trace_dense,
                "K4": trace_pallas.sweep_shells_dense,
                "K6": lane_grid_train_kernel.backward_lane}
    for f in counters.values():
        f.launches = 0
    ckpt_dir = os.path.join(ROOT, "comparison_output", "smoke_trained",
                            "studio500_ckpt")
    t0 = time.perf_counter()
    text = run_cli(train_cli.main, [
        os.path.join(ROOT, TRAINED_GATES["studio"][0]), "--steps",
        str(steps), "--batch-size", str(batch), "--segments-per-ray", "3",
        "--lr-schedule", "cosine", "--log-every", str(max(1, steps // 10)),
        "--device", dev, "--ckpt-dir", ckpt_dir])
    wall = time.perf_counter() - t0
    n = {k: f.launches for k, f in counters.items()}
    lines = re.findall(rf"step (\d+)/{steps} loss=([0-9.]+).*\(([0-9.]+) "
                       r"Msegments/s\)", text)
    loss, rate = float(lines[-1][1]), lines[-1][2]
    log(f"[train studio {steps} x {batch} x 3, cosine] {wall:.1f} s, last "
        f"loss {loss!r} (bound {STUDIO500_LOSS}), {rate} Msegments/s as "
        f"printed, launches {n} ({smi})")
    for key, count in n.items():
        if count <= 0:
            raise AssertionError(f"{key} was never launched by the studio "
                                 "training run")
    if not (int(lines[-1][0]) == steps and loss < STUDIO500_LOSS):
        raise AssertionError(f"the cut studio run ended at loss {loss}, "
                             f"not under {STUDIO500_LOSS}")


def exr_chunks(path):
    """A scanline EXR's blocks: yields (raw bytes, channels, width, lines)
    for each, so a block decoder can be driven on the channels read_exr
    does not return (alpha, Z)."""
    import struct
    with open(path, "rb") as f:
        data = f.read()
    pos, attrs = 8, {}
    while data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = data.index(b"\0", end + 1) + 1
        size = struct.unpack_from("<i", data, pos)[0]
        attrs[name] = data[pos + 4:pos + 4 + size]
        pos += 4 + size
    pos += 1
    chans, cbuf, cp = [], attrs["channels"], 0
    while cbuf[cp] != 0:
        end = cbuf.index(b"\0", cp)
        chans.append((cbuf[cp:end].decode(),
                      struct.unpack_from("<i", cbuf, end + 1)[0]))
        cp = end + 17
    lines = {8: 32, 9: 256}[attrs["compression"][0]]
    xmin, ymin, xmax, ymax = struct.unpack_from("<iiii", attrs["dataWindow"])
    nchunks = (ymax - ymin + lines) // lines
    for off in struct.unpack_from(f"<{nchunks}Q", data, pos):
        y, size = struct.unpack_from("<ii", data, off)
        yield (data[off + 8:off + 8 + size], chans, xmax - xmin + 1,
               min(lines, ymax - y + 1))


def decoders_check():
    """Phase 23 (a): the DWA fixtures against OpenEXR's decodes (the JAX
    tests' bar) and the JPEG fixtures against Pillow's, byte for byte,
    through the native and the Python entropy paths. Returns the decode
    times."""
    import numpy as np
    from neural_renderer_tpu_torch.metrics import jpeg
    from neural_renderer_tpu_torch.scene.exr import read_exr
    from neural_renderer_tpu_torch.scene.exr_dwa import dwa_uncompress_block
    golden = os.path.join(ROOT, "tests", "golden")
    times = {}
    for name in ("dwaa", "dwab"):
        path = os.path.join(golden, f"{name}_reference.exr")
        want = np.load(os.path.join(golden, f"{name}_reference_decode.npy"))
        t0 = time.perf_counter()
        got = read_exr(path)
        times[f"{name}.exr"] = (time.perf_counter() - t0) * 1e3
        ulp = np.abs(got.astype(np.float16).view(np.uint16).astype(int)
                     - want[..., :3].astype(np.float16).view(np.uint16)
                     .astype(int))
        rows = []
        fourth = "A" if name == "dwaa" else "Z"
        for raw, chans, width, ny in exr_chunks(path):
            out = dwa_uncompress_block(raw, chans, width, ny)
            sizes = [width * (4 if t == 2 else 2) for _, t in chans]
            k = [c for c, _ in chans].index(fourth)
            start, step = sum(sizes[:k]), sum(sizes)
            for r in range(ny):
                rows.append(np.frombuffer(
                    out[r * step + start:r * step + start + sizes[k]],
                    np.float16 if name == "dwaa" else np.float32))
        exact4 = np.array_equal(np.stack(rows).astype(np.float32),
                                want[..., 3])
        log(f"[formats {name}] {got.shape[1]}x{got.shape[0]} in "
            f"{times[f'{name}.exr']:.2f} ms; DCT halfs identical "
            f"{float((ulp == 0).mean())!r}, max {int(ulp.max())} half-ulps; "
            f"{fourth} bit-exact {exact4}")
        if not ((ulp == 0).mean() >= 0.999 and ulp.max() <= 4 and exact4):
            raise AssertionError(f"{name}: the DWA decode misses "
                                 "OpenEXR's")
    for name in ("studio_sky_baseline", "studio_sky_progressive",
                 "grey_restart"):
        data = open(os.path.join(golden, f"{name}.jpg"), "rb").read()
        want = np.load(os.path.join(golden, f"{name}_decode.npy"))
        for native in (True, False):
            t0 = time.perf_counter()
            got = jpeg.decode_jpeg(data, native=native)
            ms = (time.perf_counter() - t0) * 1e3
            path_name = "native" if native else "Python"
            times[f"{name}.jpg {path_name}"] = ms
            same = got.shape == want.shape and np.array_equal(got, want)
            log(f"[formats {name}.jpg] {len(data)} bytes, "
                f"{'x'.join(map(str, got.shape))}, {path_name} entropy "
                f"path {ms:.2f} ms, equal to Pillow's decode {same}")
            if not same:
                raise AssertionError(f"{name}.jpg ({path_name}) differs "
                                     "from Pillow's decode")
    return times


def formats_phase(knot7, dev="cuda", size=(480, 270), total_samples=None):
    """Phase 23: every scene and image format on the card (see the module
    docstring). knot7: phase 7's printed (PSNR, FLIP)."""
    import tempfile
    import numpy as np
    import torch
    from neural_renderer_tpu_torch import config as nr_config
    from neural_renderer_tpu_torch.cli import compare_images, evaluate
    from neural_renderer_tpu_torch.metrics.image_io import (encode_png,
                                                            load_image)
    from neural_renderer_tpu_torch.ops import (lane_grid_kernel,
                                               trace_cluster, trace_pallas,
                                               traversal)
    from neural_renderer_tpu_torch.render.renderer import (RenderBasis,
                                                           Renderer)
    from neural_renderer_tpu_torch.scene import mesh_loader
    from neural_renderer_tpu_torch.scene.scene import Scene
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from jpeg_writer import encode_jpeg
    from mesh_writers import write_fbx, write_ply, write_stl

    # (a) the decoders
    t0 = time.perf_counter()
    decoders_check()
    log(f"[formats decoders] {time.perf_counter() - t0:.2f} s")

    counters = {
        "K1": trace_cluster.sweep_clusters_stream,
        "K2": lane_grid_kernel.forward_lane, "K3": trace_pallas.trace_dense,
        "K4": trace_pallas.sweep_shells_dense,
        "K5": trace_cluster.trace_clusters_stream}
    cli_args = ["--width", str(size[0]), "--height", str(size[1])]
    if total_samples:
        cli_args += ["--total-samples", str(total_samples), "--batch-spp",
                     str(total_samples)]
    if dev != "cuda":
        cli_args += ["--device", dev]
    out_root = os.path.join(ROOT, "comparison_output", "smoke_formats")

    def evaluate_counted(cfg_path, label, *extra):
        for f in counters.values():
            f.launches = 0
        out_dir = f"{out_root}_{label}"
        with pass_launches(counters) as passes:
            text = run_evaluate(evaluate, [cfg_path, *cli_args, "--output",
                                           out_dir, *extra])
        psnr, flip = parse_metrics(text)
        rates = re.findall(r"(Ground truth|Neural): ([0-9.]+) Mrays/s", text)
        log(f"[formats evaluate {label} {size[0]}x{size[1]}] PSNR {psnr!r} "
            f"dB, FLIP {flip!r}, Mrays/s {rates}, launches per pass "
            f"{passes}")
        if set(passes) != {"gt", "neural"}:
            raise AssertionError(f"{label}: a pass is missing: {passes}")
        return psnr, flip, passes, out_dir

    with tempfile.TemporaryDirectory(prefix="nr_formats_") as tmp:
        # (b) the knot from PLY, STL and FBX
        t0 = time.perf_counter()
        knot_dir = os.path.join(ROOT, "configs", "knot")
        objs = {k: mesh_loader.load_mesh_auto(os.path.join(knot_dir,
                                                           f"{k}.obj"))
                for k in ("original", "outer", "inner")}
        o = objs["original"]
        files = {"original": os.path.join(tmp, "original.ply"),
                 "outer": os.path.join(tmp, "outer.stl"),
                 "inner": os.path.join(tmp, "inner.fbx")}
        write_ply(files["original"], o.vertices, o.indices, o.normals)
        write_stl(files["outer"], objs["outer"].vertices,
                  objs["outer"].indices)
        write_fbx(files["inner"], objs["inner"].vertices,
                  objs["inner"].indices)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = {k: mesh_loader.load_mesh_auto(p) for k, p in files.items()}
        t_load = time.perf_counter() - t0
        ply = loaded["original"]
        ply_exact = all(
            getattr(ply, n).dtype == getattr(o, n).dtype
            and np.array_equal(getattr(ply, n).view(np.uint32),
                               getattr(o, n).view(np.uint32))
            for n in ("vertices", "indices", "normals"))
        shells = {}
        for key in ("outer", "inner"):
            a = loaded[key].vertices[loaded[key].indices.astype(np.int64)]
            b = objs[key].vertices[objs[key].indices.astype(np.int64)]
            differ = a.view(np.uint32) != b.view(np.uint32)
            shells[key] = dict(
                triangles=a.shape[0], equal=a.shape == b.shape
                and bool(np.array_equal(a, b)),
                bits_differ=int(differ.sum()),
                differ_are_signed_zeros=bool((b[differ] == 0).all()))
        log(f"[formats knot] wrote PLY/STL/FBX in {t_write:.2f} s, loaded "
            f"in {t_load:.2f} s ({ {k: os.path.getsize(p) for k, p in files.items()} } "
            f"bytes); PLY arrays equal the OBJ's bit for bit {ply_exact}; "
            f"shells {shells}")
        if not (ply_exact and all(s["equal"] and s["differ_are_signed_zeros"]
                                  for s in shells.values())):
            raise AssertionError("the knot's PLY/STL/FBX meshes differ from "
                                 "the OBJ loader's")
        cfg = json.load(open(os.path.join(knot_dir, "knot_lane.json")))
        for key, mesh_key in (("original", "original_mesh"),
                              ("inner", "inner_shell"),
                              ("outer", "outer_shell")):
            cfg["scene"][mesh_key]["path"] = files[key]
        cfg["checkpoint_path"] = os.path.join(knot_dir, cfg["checkpoint_path"])
        knot_cfg = os.path.join(tmp, "knot_formats.json")
        with open(knot_cfg, "w") as f:
            json.dump(cfg, f)
        psnr, flip, passes, _ = evaluate_counted(knot_cfg, "knot")
        if not (passes["gt"]["K5"] > 0 and passes["neural"]["K1"] > 0
                and passes["neural"]["K2"] > 0):
            raise AssertionError(f"the knot from PLY/STL/FBX did not run "
                                 f"through K5, K1 and K2: {passes}")
        if not (psnr >= KNOT_GATE["psnr"] and flip <= KNOT_GATE["flip"]):
            raise AssertionError("the knot from PLY/STL/FBX misses the "
                                 f"quality gate {KNOT_GATE}")
        if (psnr, flip) != tuple(knot7):
            raise AssertionError(f"the knot from PLY/STL/FBX prints PSNR "
                                 f"{psnr} / FLIP {flip}, phase 7 {knot7}")
        log(f"[formats knot] PSNR {psnr!r} dB, FLIP {flip!r}: phase 7's "
            f"{knot7} to the printed digit ({time.perf_counter() - t0:.2f}"
            " s)")

        # (c) the studio under a JPEG sky and a DWAB sky
        studio_dir = os.path.join(ROOT, "configs", "studio")
        base = json.load(open(os.path.join(studio_dir, "studio_lane.json")))
        for mesh_key in ("original_mesh", "inner_shell", "outer_shell",
                         "additional_mesh"):
            base["scene"][mesh_key]["path"] = os.path.join(
                studio_dir, base["scene"][mesh_key]["path"])
        base["checkpoint_path"] = os.path.join(studio_dir,
                                               base["checkpoint_path"])
        studio = {}
        for label, sky in FORMATS_STUDIO_SKIES:
            t0 = time.perf_counter()
            base["environment"]["hdri_path"] = os.path.join(
                ROOT, "tests", "golden", sky)
            cfg_path = os.path.join(tmp, f"studio_{label}.json")
            with open(cfg_path, "w") as f:
                json.dump(base, f)
            scfg = nr_config.load_config(cfg_path)
            scene = Scene.from_config(scfg)
            env = scene.environment
            if not (env.is_valid and scene.environment_error is None):
                raise AssertionError(f"the {sky} sky did not load")
            rend = Renderer(scene, scfg.neural_network, device=dev)
            if not rend.load_weights_from_file(scfg.checkpoint_path):
                raise AssertionError("the studio weights do not load")
            rend.set_use_additional_mesh(False)
            pos, yaw, pitch = nr_config.matrix_to_camera_state(
                scfg.camera.matrix)
            rend.set_camera_basis(RenderBasis(
                *nr_config.camera_basis_from_state(yaw, pitch,
                                                   scfg.camera.yfov)))
            rend.set_bounce_count(scfg.rendering.bounce_count)
            rend.set_envmap_rotation(scfg.environment.rotation)
            rend.resize(*size)
            frames = {}
            for pass_label, neural in (("ground truth", False),
                                       ("neural", True)):
                rend.set_use_neural_query(neural)
                img_k = rend.render_accumulate(pos, 2, batch_spp=1)
                with twin_path(lane_grid_kernel, trace_cluster, trace_pallas,
                               traversal):
                    img_t = rend.render_accumulate(pos, 2, batch_spp=1)
                diff = abs(img_k.astype(int) - img_t.astype(int))
                frames[pass_label] = dict(
                    share_above_3=float((diff > 3).mean()),
                    mean=float(diff.mean()), max=int(diff.max()),
                    mean_u8=float(img_k.mean()))
                if not (frames[pass_label]["share_above_3"] < 0.02
                        and frames[pass_label]["mean"] < 1.0
                        and img_k.std() > 1.0):
                    raise AssertionError(f"studio under {sky}: the "
                                         f"{pass_label} kernel frame differs "
                                         "from the twin frame")
            log(f"[formats studio {label} sky {env.width}x{env.height}] "
                f"kernels vs twins {frames}")
            psnr, flip, passes, out_dir = evaluate_counted(
                cfg_path, f"studio_{label}", "--no-additional")
            if any(passes[p][k] != 0 for p in passes for k in ("K1", "K5")):
                raise AssertionError(f"studio {label}: a clustered kernel "
                                     f"launched: {passes}")
            if not (passes["gt"]["K3"] > 0 and passes["neural"]["K4"] > 0
                    and passes["neural"]["K2"] > 0):
                raise AssertionError(f"studio {label}: no K3 / K4 / K2 "
                                     f"launch: {passes}")
            studio[label] = dict(psnr=psnr, flip=flip, out_dir=out_dir)
            log(f"[formats studio {label}] {time.perf_counter() - t0:.2f} s")

        # (d) compare_images on the card
        t0 = time.perf_counter()

        def compare(ref, test):
            argv = [ref, test] + ([] if dev == "cuda" else ["--device", dev])
            text = run_cli(compare_images.main, argv)
            return (*parse_metrics(text), "Detected Y-flipped" in text)

        for label, run in studio.items():
            gt = os.path.join(run["out_dir"], "ground_truth.png")
            nn = os.path.join(run["out_dir"], "neural.png")
            got = compare(gt, nn)
            if got != (run["psnr"], run["flip"], False):
                raise AssertionError(f"compare_images on the {label} pass "
                                     f"prints {got}, evaluate printed "
                                     f"{run['psnr']} / {run['flip']}")
        run = studio["jpeg"]
        neural = load_image(os.path.join(run["out_dir"], "neural.png"))
        jpg = os.path.join(tmp, "neural.jpg")
        with open(jpg, "wb") as f:
            f.write(encode_jpeg(neural, quality=95))
        flipped = os.path.join(tmp, "neural_flipped.png")
        with open(flipped, "wb") as f:
            f.write(encode_png(neural[::-1]))
        gt = os.path.join(run["out_dir"], "ground_truth.png")
        as_jpeg = compare(gt, jpg)
        as_flipped = compare(gt, flipped)
        log(f"[formats compare_images] PNG pairs as evaluate printed; the "
            f"neural image as JPEG (q95): PSNR {as_jpeg[0]!r}, FLIP "
            f"{as_jpeg[1]!r}; flipped: {as_flipped} "
            f"({time.perf_counter() - t0:.2f} s)")
        if as_jpeg[2] or abs(as_jpeg[0] - run["psnr"]) > 1.0:
            raise AssertionError("compare_images on the JPEG neural image "
                                 f"is off: {as_jpeg}")
        if as_flipped != (run["psnr"], run["flip"], True):
            raise AssertionError("compare_images did not undo the flip: "
                                 f"{as_flipped}")
    if dev == "cuda":
        torch.cuda.synchronize()

def k5_items(label, trace_cluster, bounds, args, mode, t, tri, swept, ms,
             kernel, mxu):
    """Log how a clustered closest-hit kernel's work items split the walk:
    the per-block swept distribution, W (rays per item), the pairs the
    kernel swept (its items' walks and the passengers' pass) against the
    block rule's pairs, each with its bound, and the wrapper's time `ms`
    beside the device time of its kernels per `kernel()` call. Fails
    unless one more (uncounted) launch gives the same t, ids and per-block
    swept, the items' counts reduce by max to it and the kernel's schedule
    equals `work_order`. Returns the bound's operation seconds on (the
    items' pairs, the block rule's); with `mxu` their conversions and
    epilogue on the pairs `trace_cluster.epilogue_pairs` counts."""
    import torch
    res = trace_cluster.item_sweeps(*args, mode, mxu=mxu)
    items, item_pairs = res["items"], res["pairs"]
    w = trace_cluster.ITEM_RAYS
    if not (torch.equal(res["t"], t) and torch.equal(res["tri"], tri)
            and torch.equal(res["swept"], swept)
            and torch.equal(items.amax(dim=1), swept)
            and torch.equal(res["order"],
                            trace_cluster.work_order(args[5]))):
        raise AssertionError(f"{label}: work items disagree with the "
                             "block rule or the schedule with work_order")
    size = trace_cluster.CLUSTER_SIZE
    block_pairs = int(swept.sum()) * 512 * size
    if mxu:
        block_walks = swept[:, None].expand_as(items)
        item_s, block_s = (bounds.mxu_seconds(n, converted=trace_cluster
                                              .epilogue_pairs(*args[:4], w,
                                                              mode))
                           for n, w in ((item_pairs, res["walks"]),
                                        (block_pairs, block_walks)))
    else:
        item_s, block_s = (bounds.trace_seconds("local", n)
                           for n in (item_pairs, block_pairs))
    dev = device_ms(kernel, "nr_trace_cluster")
    log(f"[{label} items] W {w} rays per item, {items.numel()} items; "
        f"swept per block max {int(swept.max())}, mean "
        f"{swept.float().mean().item():.3f}, blocks with none "
        f"{int((swept == 0).sum())} of {swept.numel()}; pairs: items "
        f"{item_pairs} of the block rule's {block_pairs} "
        f"({item_pairs / max(block_pairs, 1):.4f}); kernel {ms:.4f} ms a "
        f"wrapper call, "
        f"{'not measured' if dev is None else f'{dev:.4f}'} ms of its "
        f"kernels' device time, against {block_s * 1e3:.4f} ms on the block "
        f"rule's pairs and {item_s * 1e3:.4f} ms on the items'")
    return item_s, block_s


def dense_case(fn, twin, operands, mode, real_tris, timings, fp32=False):
    """One case of a dense kernel (K8, K4-MXU; with fp32 K3, K4) on
    operands (origins, dirs, triangles, skip flags), fn() the call of its
    wrapper and twin() its twin's result: rays, live 512-ray blocks,
    whether fn() equals twin() bit for bit, the pairs the prefilter leaves
    (to the matrix form's epilogue; to the FP32 kernels' second test and
    to the rest of Möller–Trumbore), the bound on the live blocks' real
    pairs (the FP32 kernels' also at 46 operations a pair) and
    timings(fn)'s times. scripts/compare_trace_cluster_kernels.py runs it
    on earlier checkouts too: one without the prefilter's count bounds the
    pairs as it did then."""
    import torch
    from neural_renderer_tpu_torch.ops import bounds, trace_mxu, trace_pallas
    mask = operands[3]
    live = int(mask.sum())
    pairs = live * 512 * real_tris
    res = dict(rays=int(operands[0].shape[1]), live_blocks=live,
               blocks=int(mask.numel()), tris=real_tris,
               exact=bool(torch.equal(fn(), twin())))
    if fp32:
        res["mt46_bound_ms"] = bounds.trace_seconds("local", pairs) * 1e3
        res["bound_ms"] = res["mt46_bound_ms"]
        if hasattr(trace_pallas, "prefilter_pairs"):
            left = trace_pallas.prefilter_pairs(*operands[:4], mode)
            res["prefilter_pairs"] = left
            res["bound_ms"] = bounds.dense_seconds(pairs, *left) * 1e3
    elif hasattr(trace_mxu, "epilogue_pairs"):
        res["epilogue_pairs"] = trace_mxu.epilogue_pairs(*operands[:4], mode)
        res["bound_ms"] = bounds.mxu_seconds(
            pairs, converted=res["epilogue_pairs"]) * 1e3
    else:
        res["bound_ms"] = bounds.mxu_seconds(pairs) * 1e3
    res.update(timings(fn))
    return res


def first_live_block(o, d, mask):
    """(origins, dirs, flag) of the first live 512-ray block of a dense
    kernel's operands, alone: a launch with the most triangle slices."""
    b = int(mask.nonzero()[0])
    return (o[:, b * 512:(b + 1) * 512].contiguous(),
            d[:, b * 512:(b + 1) * 512].contiguous(),
            mask[b:b + 1].contiguous())


def smoke_times(fn, ms=None):
    """A dense case's times in the kernels line: the wrapper's ms per call
    (time_ms unless given) and the device ms of all the kernels one call
    launches (torch.profiler)."""
    dev = device_ms(fn, "")
    return dict(ms=time_ms(fn) if ms is None else ms,
                device_ms="not measured" if dev is None else dev)


@contextlib.contextmanager
def recording_dense(traversal, trace_mxu, matrix=True):
    """For the duration of the block, record the operands (cloned) of every
    dense trace made through `traversal.trace_dense` in the matrix
    formulation (matrix) or the FP32 one (not matrix): yields the list of
    (origins, dirs, triangles, mode, skip flags)."""
    calls, real = [], traversal.trace_dense

    def record(o, d, tp, mode, mask, mxu=None):
        if trace_mxu.use_mxu(mxu) == matrix:
            calls.append((o.clone(), d.clone(), tp, mode, mask.clone()))
        return real(o, d, tp, mode, mask, mxu=mxu)

    traversal.trace_dense = record
    try:
        yield calls
    finally:
        traversal.trace_dense = real


def hold(label, got, want, bounds, ids_got=None, ids_want=None):
    """Hold trace t (and ids) `got` against `want` to `bounds`: hit flips
    under 2e-3, t within rtol/atol where both hit (on the same triangle
    with t_same_id), ids equal on the share bounds["ids"]; returns the
    largest |dt|."""
    from neural_renderer_tpu_torch.ops import trace_mxu
    a = trace_mxu.agreement(got, want, ids_got, ids_want,
                            bounds["rtol"], bounds["atol"])
    log(f"[{label}] hit flips {a['flips']!r}, both hit {a['both']}, "
        f"max|dt| {a['max_abs']!r}, max rel dt {a['max_rel']!r}, ids "
        f"equal {a['ids']!r}")
    within = a["within"]
    if bounds.get("t_same_id"):
        same = ids_got == ids_want
        s = trace_mxu.agreement(got[same], want[same],
                                rtol=bounds["rtol"], atol=bounds["atol"])
        log(f"[{label}] on the same triangle: max|dt| "
            f"{s['max_abs']!r}, max rel dt {s['max_rel']!r}")
        within = s["within"]
    if not (a["flips"] < 2e-3 and within
            and a["ids"] >= bounds["ids"]):
        raise AssertionError(f"{label}: outside {bounds}")
    return a["max_abs"]


# The keys of bench.py's last line (bench.py:279-291).
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "repeats", "min",
              "max"}


def ablation_phase(kernels, launches):
    """Phase 20: drive the trace-kernel ablation with its counters at 0,
    then hold each of its kernels against its twin and the production
    kernels; adds a "K9 <variant>" entry per new kernel to `kernels` and
    its launches to `launches`."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import ablate_trace_kernel_torch as ablate
    from neural_renderer_tpu_torch.ops import trace_ablation as ta
    from neural_renderer_tpu_torch.ops import trace_mxu, trace_pallas

    counters = (ta.trace_variant.launches, ta.sweep_variant.launches,
                ta.trace_mxu_bf16.launches)
    for c in counters:
        c.clear()
    traces, sweeps, (o, d, tris), (so, sd, stris, scols) = ablate.run(
        ablate.DEFAULT_VARIANTS + ABLATE_EXTRA)
    counts = [dict(c) for c in counters]
    failed = [k for k, v in {**traces, **sweeps}.items()
              if isinstance(v, Exception)]
    if failed:
        raise AssertionError(f"ablation variants failed: {failed}")
    log(f"[K9 ablation] launches {counts}")

    def twin_all(fn, o, d):
        """fn over ABLATE_CHUNK-ray chunks of all the rays: (out, ms)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = torch.cat([fn(o[:, i:i + ABLATE_CHUNK].contiguous(),
                            d[:, i:i + ABLATE_CHUNK].contiguous())
                         for i in range(0, o.shape[1], ABLATE_CHUNK)],
                        dim=1)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    def ids(x):
        return x[1].view(torch.int32)

    def exact(label, got, want):
        err = (got[0] - want[0]).abs().max().item()
        same = torch.equal(got, want)
        log(f"[{label}] max|dt| {err!r}, bit-exact {same}")
        if not same:
            raise AssertionError(f"{label}: not bit-exact")
        return err

    def hold_bf16(label, got, want):
        hit_g, hit_w = got < trace_pallas.MISS, want < trace_pallas.MISS
        both = hit_g & hit_w
        flips = (hit_g != hit_w).double().mean().item()
        rel = ((got - want).abs() / want.abs())[both].double()
        med = rel.median().item() if rel.numel() else 0.0
        log(f"[{label}] hit flips {flips!r}, median rel dt {med!r}, max "
            f"{rel.max().item() if rel.numel() else 0.0!r}")
        if not (flips < ABLATE_BF16["flips"]
                and med < ABLATE_BF16["median_rel"]):
            raise AssertionError(f"{label}: outside {ABLATE_BF16}")

    def hold_share(label, got, want):
        b = ABLATE_MXU_BF16
        a = trace_mxu.agreement(got[0], want[0], ids(got), ids(want),
                                b["rtol"], b["atol"])
        both = (got[0] < trace_pallas.MISS) & (want[0] < trace_pallas.MISS)
        diff = (got[0] - want[0]).abs()[both]
        share = (diff <= b["atol"] + b["rtol"] * want[0].abs()[both]) \
            .double().mean().item()
        log(f"[{label}] hit flips {a['flips']!r}, both hit {a['both']}, "
            f"within {b['rtol']} on {share!r} of them, max|dt| "
            f"{a['max_abs']!r}, max rel dt {a['max_rel']!r}, ids equal "
            f"{a['ids']!r}")
        if not (a["flips"] < 2e-3 and share >= b["share"]
                and a["max_rel"] <= b["max_rel"] and a["ids"] >= b["ids"]):
            raise AssertionError(f"{label}: outside {b}")
        return a["max_abs"]

    def entry(label, name, source, replaces, err, res, pms, count, nbytes_):
        if count <= 0:
            raise AssertionError(f"K9 {label} was never launched by the "
                                 "ablation")
        launches[f"K9 {label}"] = count
        log(f"[time K9 {label}] kernel {res['ms']:.4f} ms, twin {pms:.4f} "
            f"ms, bound {res['bound_ms']:.4f} ms, launches {count}")
        kernels[f"K9 {label}"] = dict(
            name=name, route="cuda",
            source="neural_renderer_tpu_torch/csrc/" + source,
            replaces=replaces, max_abs_err=err, ms=res["ms"], plain_ms=pms,
            ops_seconds=res["bound_ms"] * 1e-3, bytes=nbytes_,
            library_ms=None)
        if "pair_bound_ms" in res:
            # The prefiltered kernels (the trace variants on K3's walk,
            # mxu_hi3, mxu_lo, the sweep variants): bound_ms counts what the
            # rule leaves, this bound every pair.
            slots = (" (every pair of each slot where it leaves one)"
                     if label in ta.MXU_BF16_PASSES else "")
            log(f"[bound K9 {label}] on the pairs its prefilter leaves "
                f"{res['bound_ms']:.4f} ms, on every pair "
                f"{res['pair_bound_ms']:.4f} ms; the rule leaves "
                f"{res['survivors']!r} of the pairs{slots}")
            kernels[f"K9 {label}"].update(
                pair_ops_seconds=res["pair_bound_ms"] * 1e-3,
                survivors=res["survivors"])

    k3 = traces["current"]["out"]
    n = o.shape[1]
    log(f"[K9 local/current] {traces['local']['ms']:.4f} / "
        f"{traces['current']['ms']:.4f} ms = "
        f"{traces['local']['ms'] / traces['current']['ms']!r}")
    for label, (var, block, tile) in ta.TRACE_COMBOS.items():
        res = traces[label]
        ker = res["out"]
        tp = ablate.padded(tris, tile)
        twin, pms = twin_all(lambda a, b: ta.trace_variant_twin(
            a, b, tp, var, tile), o, d)
        if var == "recipx":
            err = hold(f"K9 {label} vs twin", ker[0], twin[0], ABLATE_ULPS,
                       ids(ker), ids(twin))
        else:
            err = exact(f"K9 {label} vs twin", ker, twin)
        if var in ("local", "recip"):
            exact(f"K9 {label} vs K3", ker, k3)
        elif var in ("nodiv", "recipx"):
            hold(f"K9 {label} vs K3", ker[0], k3[0], ABLATE_ULPS, ids(ker),
                 ids(k3))
        elif var == "bf16":
            hold_bf16(f"K9 {label} vs K3", ker[0], k3[0])
        entry(label, f"ablate_trace {label} (K9: {var} tile math, {block} "
              f"rays x {tile} triangles)", "ablate_trace.cu",
              "scripts/ablate_trace_kernel.py:149", err, res, pms,
              counts[0].get(f"{var}/{block}/{tile}", 0),
              nbytes(o, d, tp) + 2 * 4 * n)

    tp = ablate.padded(tris, trace_pallas.TRI_TILE)
    ones = torch.ones(ABLATE_CHUNK // trace_pallas.BLOCK_RAYS,
                      dtype=torch.int32, device=o.device)
    k8 = traces["mxu_hi"]["out"]
    k8_twin, _ = twin_all(lambda a, b: trace_pallas.trace_dense_twin(
        a, b, tp, 0, ones, mxu=True), o, d)
    exact("K9 mxu_hi (K8) vs twin", k8, k8_twin)
    hold("K9 mxu_hi (K8) vs K3", k8[0], k3[0], MXU_DENSE_VPU, ids(k8),
         ids(k3))
    all_ones = torch.ones(n // trace_pallas.BLOCK_RAYS, dtype=torch.int32,
                          device=o.device)
    kernels["K8"]["cases"]["g"] = dense_case(
        lambda: trace_mxu.trace_dense_mxu(o, d, tp, 0, all_ones),
        lambda: k8_twin, (o, d, tp, all_ones), 0, tp.shape[1],
        lambda fn: smoke_times(fn, ms=traces["mxu_hi"]["ms"]))
    k3_twin, _ = twin_all(lambda a, b: trace_pallas.trace_dense_twin(
        a, b, tp, 0, ones), o, d)
    exact("K9 current (K3) vs twin", k3, k3_twin)
    kernels["K3"]["cases"]["g"] = dense_case(
        lambda: trace_pallas.trace_dense(o, d, tp, 0, all_ones, mxu=False),
        lambda: k3_twin, (o, d, tp, all_ones), 0, tp.shape[1],
        lambda fn: smoke_times(fn, ms=traces["current"]["ms"]), fp32=True)
    for label, passes in ta.MXU_BF16_PASSES.items():
        res = traces[label]
        ker = res["out"]
        twin, pms = twin_all(lambda a, b: ta.trace_mxu_bf16_twin(
            a, b, tp, passes), o, d)
        err = hold_share(f"K9 {label} vs twin", ker, twin)
        entry(label, f"ablate_mxu_bf16 {label} (K8's matrix form with "
              f"{passes}-pass bf16 products)", "ablate_mxu_bf16.cu",
              "neural_renderer_tpu/ops/trace_mxu.py:112", err, res, pms,
              counts[2].get(passes, 0), nbytes(o, d, tp) + 2 * 4 * n)

    k4 = sweeps["sweep"]["out"]
    exact("K9 sweep_nof2 (K4) vs K4 rows 0-3", sweeps["sweep_nof2"]["out"],
          k4[:4])
    sones = torch.ones(ABLATE_CHUNK // trace_pallas.BLOCK_RAYS,
                       dtype=torch.int32, device=so.device)
    k4m = sweeps["sweep_mxu"]["out"]
    k4m_twin, _ = twin_all(lambda a, b: trace_pallas.sweep_shells_dense_twin(
        a, b, stris, scols, True, sones, mxu=True), so, sd)
    exact("K9 sweep_mxu (K4-MXU) vs twin, every row", k4m, k4m_twin)
    sweep_all = torch.ones(so.shape[1] // trace_pallas.BLOCK_RAYS,
                           dtype=torch.int32, device=so.device)
    kernels["K4-MXU"]["cases"]["i"] = dense_case(
        lambda: trace_pallas.sweep_shells_dense_mxu(so, sd, stris, scols,
                                                    True, sweep_all),
        lambda: k4m_twin, (so, sd, stris, sweep_all), 0, stris.shape[1],
        lambda fn: smoke_times(fn, ms=sweeps["sweep_mxu"]["ms"]))
    k4_twin, _ = twin_all(lambda a, b: trace_pallas.sweep_shells_dense_twin(
        a, b, stris, scols, True, sones), so, sd)
    exact("K9 sweep (K4) vs twin, every row", k4, k4_twin)
    kernels["K4"]["cases"]["i"] = dense_case(
        lambda: trace_pallas.sweep_shells_dense(so, sd, stris, scols, True,
                                                sweep_all, mxu=False),
        lambda: k4_twin, (so, sd, stris, sweep_all), 0, stris.shape[1],
        lambda fn: smoke_times(fn, ms=sweeps["sweep"]["ms"]), fp32=True)
    for row in range(5):
        # Against K4, the dense trace's bounds: on these camera rays from
        # distance 3 the matrix form's t error is absolute (t·det = o·n -
        # v0·n cancels terms of size |o||n|), up to 3.0e-5 at t ~ 2.8 on
        # the CPU twins; phase 17's sweep bound (1e-6 absolute) holds on
        # its small shells only.
        hold(f"K9 sweep_mxu (K4-MXU) vs K4 row {row}", k4m[row], k4[row],
             MXU_DENSE_VPU)
    for var in ta.SWEEP_VARIANTS:
        label = f"sweep_{var}"
        res = sweeps[label]
        ker = res["out"]
        pairs = ta.variant_pairs(var)
        twin, pms = twin_all(lambda a, b: trace_pallas.sweep_shells_dense_twin(
            a, b, stris, scols, True, sones, pairs=pairs), so, sd)
        err = 0.0
        for row in range(5):
            if var == "recipx":
                err = max(err, hold(f"K9 {label} vs twin row {row}",
                                    ker[row], twin[row], ABLATE_ULPS))
            else:
                err = max(err, exact(f"K9 {label} vs twin row {row}",
                                     ker[row:row + 1], twin[row:row + 1]))
            if var == "recip":
                exact(f"K9 {label} vs K4 row {row}", ker[row:row + 1],
                      k4[row:row + 1])
            elif var == "bf16":
                hold_bf16(f"K9 {label} vs K4 row {row}", ker[row], k4[row])
            else:
                hold(f"K9 {label} vs K4 row {row}", ker[row], k4[row],
                     ABLATE_ULPS)
        entry(label, f"ablate_sweep {label} (K4's dense dual-shell sweep "
              f"with K9's {var} tile math)", "ablate_sweep.cu",
              "neural_renderer_tpu/ops/trace_pallas.py:95", err, res, pms,
              counts[1].get(var, 0), nbytes(so, sd, stris) + 5 * 4 * n)


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


# What the JAX profiler fills on each branch without an additional mesh
# (neural_renderer_tpu/render/profiler.py).
PROFILE_CATEGORIES = {
    False: ("primaryTrace", "initPathState", "sampleBounce", "bounceTrace",
            "integrateBounce", "finalize"),
    True: ("shellTrace", "neuralForward", "initPathState", "sampleBounce",
           "earlyTermination", "integrateBounce", "finalize")}


def viewer_phase(smi, dev="cuda", size=(W, H), small=(480, 270)):
    """Phase 24: the viewer on the lane sphere (see the module docstring).
    `size` is the full frame, `small` the 480x270 one."""
    import argparse
    import numpy as np
    import torch
    from neural_renderer_tpu_torch.cli import train as train_cli
    from neural_renderer_tpu_torch.cli import viewer
    from neural_renderer_tpu_torch.metrics import load_image
    from neural_renderer_tpu_torch.ops import (denoise, lane_grid_kernel,
                                               lane_grid_train_kernel,
                                               trace_cluster, trace_pallas,
                                               traversal)
    from neural_renderer_tpu_torch.render.profiler import profile_renderer
    on_gpu = torch.device(dev).type == "cuda"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    cfg = os.path.join(ROOT, "configs", "sphere", "sphere_lane.json")
    out = os.path.join(ROOT, "comparison_output", "smoke_viewer")
    fw, fh = (str(v) for v in size)
    sw, sh = (str(v) for v in small)
    counters = {"K1": trace_cluster.sweep_clusters_stream,
                "K2": lane_grid_kernel.forward_lane,
                "K3": trace_pallas.trace_dense,
                "K5": trace_cluster.trace_clusters_stream,
                "K6": lane_grid_train_kernel.backward_lane}

    def counted(argv, keep=lambda line: True):
        for f in counters.values():
            f.launches = 0
        text = run_cli(viewer.main, argv + ["--device", dev], keep)
        return text, {k: f.launches for k, f in counters.items()}

    frame_re = (r"frame \d+: (\d+) spp accumulated, ([0-9.]+) Mrays/s, "
                r"([0-9.]+) fps")

    # (a) headless, neural, 1 spp a frame
    text, la = counted([cfg, "--headless", "4", "--width", fw, "--height",
                        fh, "--output", out + "_a"])
    frames = re.findall(frame_re, text)
    img = load_image(os.path.join(out + "_a", "viewer_final.png"))
    log(f"[viewer headless {fw}x{fh}] spp, Mrays/s, fps per frame "
        f"{frames}, launches {la} ({smi})")
    if [int(f[0]) for f in frames] != [1, 2, 3, 4]:
        raise AssertionError("the headless viewer did not reach 4 spp")
    if not (la["K1"] > 0 and la["K2"] > 0):
        raise AssertionError(f"the viewer's frames missed K1 or K2: {la}")
    if img.shape != (size[1], size[0], 3) or not img.std() > 1.0:
        raise AssertionError("the viewer's final image is malformed")

    # (b) the same four frames, denoised
    rend_args = argparse.Namespace(config=cfg, device=dev, width=size[0],
                                   height=size[1], spp=1, ckpt="")
    _, rend, ctl, basis = viewer.build_renderer(rend_args)
    rend.set_camera_basis(basis())
    pos = ctl.camera.position
    rend.set_denoise(True)
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        img_d = rend.render(pos)
        walls.append(time.perf_counter() - t0)
    acc = rend._accum.reshape(3, size[1], size[0])
    normals, albedo = rend._guides
    t0 = time.perf_counter()
    ref = denoise.bilateral_denoise(acc.cpu(), rend.accum_sample_count,
                                    normals.cpu(), albedo.cpu()).numpy()
    cpu_s = time.perf_counter() - t0
    diff = np.abs(img_d.astype(int) - ref.astype(int))
    den_ms = time_ms(lambda: denoise.bilateral_denoise(
        acc, rend.accum_sample_count, normals, albedo), reps=5)
    log(f"[viewer denoise {fw}x{fh}] {rend.accum_sample_count} spp; frame "
        f"wall s {walls}; card vs CPU: max |d| {int(diff.max())}, share of "
        f"pixels differing {float((diff.max(axis=-1) > 0).mean())!r}; "
        f"denoise {den_ms!r} ms on the card (CUDA events, mean of 5), "
        f"{cpu_s:.3f} s on the CPU ({smi})")
    if rend.accum_sample_count != 4 or diff.max() > 1:
        raise AssertionError("the card's denoised frame differs from the "
                             "CPU's by more than 1 u8 step")

    # (c) the Lambert view
    rend.set_denoise(False)
    rend.set_lambert_view(True)
    rend.resize(*small)
    lam = {}
    for neural in (False, True):
        rend.set_use_neural_query(neural)
        img_k = rend.render(pos)
        with twin_path(lane_grid_kernel, trace_cluster, trace_pallas,
                       traversal):
            img_t = rend.render(pos)
        d = np.abs(img_k.astype(int) - img_t.astype(int))
        lam["neural" if neural else "gt"] = dict(
            identical=bool((d == 0).all()), share_above_3=float(
                (d > 3).mean()), mean=float(d.mean()),
            mean_u8=float(img_k.mean()))
    rend.set_use_neural_query(False)
    rend.set_classic_mesh_index(1)
    trace_pallas.trace_dense.launches = 0
    img_inner = rend.render(pos)
    k3_inner = trace_pallas.trace_dense.launches
    rend.set_classic_mesh_index(0)
    log(f"[viewer lambert {sw}x{sh} kernels vs twins] {lam}; the inner "
        f"shell as the classic mesh: K3 launches {k3_inner}")
    if not (lam["gt"]["identical"] and lam["neural"]["share_above_3"] < 0.02
            and lam["neural"]["mean"] < 1.0 and k3_inner > 0
            and img_inner.std() > 1.0):
        raise AssertionError("a Lambert view differs from its twin frame "
                             "or the classic shell missed K3")
    rend.resize(*size)
    lam_ms = {}
    for neural in (False, True):
        rend.set_use_neural_query(neural)
        rend.render(pos)
        t0 = time.perf_counter()
        for _ in range(3):
            rend.render(pos)
        lam_ms["neural" if neural else "gt"] = \
            (time.perf_counter() - t0) / 3 * 1e3
    log(f"[viewer lambert {fw}x{fh}] wall ms per frame (with readback) "
        f"{lam_ms} ({smi})")
    rend.set_lambert_view(False)

    # (d) the motion bench
    text, _ = counted([cfg, "--bench-motion", "3", "--motion-drop", "4",
                       "--width", fw, "--height", fh, "--output",
                       out + "_d"])
    motion = re.search(r"motion: (\d+) frames .* -> ([0-9.]+) fps "
                       r"\(median frame ([0-9.]+) ms", text)
    rest = re.search(r"rest: (\d+) spp .* \(([0-9.]+) Mrays/s\)", text)
    if not (motion and rest and int(motion.group(1)) > 0
            and int(rest.group(1)) == 64):
        raise AssertionError("the motion bench printed no result")
    log(f"[viewer bench-motion] preview fps {motion.group(2)}, median frame "
        f"{motion.group(3)} ms, rest {rest.group(2)} Mrays/s ({smi})")

    # (e) train-while-render
    ckpt_dir = os.path.join(ROOT, "comparison_output", "smoke_live",
                            "live_ckpt")
    text, le = counted([cfg, "--headless", "3", "--train-steps", "4",
                        "--train-batch", "16384", "--width", sw, "--height",
                        sh, "--train-ckpt-dir", ckpt_dir, "--output",
                        out + "_e"])
    frames = re.findall(frame_re + r", loss ([0-9.naif]+) \(([0-9.]+) "
                        r"train steps/s\)", text)
    losses = [float(f[3]) for f in frames]
    weights = re.search(r"^checkpoint: (\S+)", text, re.M)
    log(f"[viewer train-while-render {sw}x{sh}] losses {losses}, train "
        f"steps/s {[float(f[4]) for f in frames]}, spp "
        f"{[int(f[0]) for f in frames]}, launches {le} ({smi})")
    if not ("(warm start)" in text and len(frames) == 3
            and np.isfinite(losses).all()
            and [int(f[0]) for f in frames] == [1, 1, 1] and weights
            and os.path.exists(weights.group(1))):
        raise AssertionError("train-while-render went wrong")
    if not all(le[k] > 0 for k in ("K1", "K2", "K5", "K6")):
        raise AssertionError(f"train-while-render missed a kernel: {le}")
    text = run_cli(train_cli.main, [
        cfg, "--resume", weights.group(1), "--steps", "13", "--batch-size",
        "16384", "--log-every", "1", "--device", dev, "--ckpt-dir",
        os.path.join(ROOT, "comparison_output", "smoke_live",
                     "resumed_ckpt")])
    if not ("from step 12" in text and "step 13/13" in text):
        raise AssertionError("cli/train.py --resume did not take the "
                             "viewer's checkpoint")

    # (f) the stage profiler
    for neural in (False, True):
        rend.set_use_neural_query(neural)
        t = profile_renderer(rend, pos, neural)
        filled = {k: v for k, v in t.ms.items() if v > 0}
        ratio = sum(filled.values()) / t.frame_total_ms
        log(f"[viewer profile {'neural' if neural else 'gt'} {fw}x{fh}] "
            f"({smi})\n" + t.table() + f"\ncategory sum / frame total "
            f"{ratio!r}")
        missing = [k for k in PROFILE_CATEGORIES[neural] if k not in filled]
        if missing or not t.frame_total_ms > 0:
            raise AssertionError(f"the profile left {missing} at 0")

    # (g) memory
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    log(f"[viewer memory_stats] {json.dumps(rend.memory_stats())}; peak "
        f"device memory of the phase {peak / 2**20:.0f} MiB ({smi})")


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
    accum, Mrays/s)."""
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
    return img, accum, mrays


@contextlib.contextmanager
def twin_path(lane_grid_kernel, trace_cluster, trace_pallas, traversal,
              network=True):
    """Route the five kernel entry points to their PyTorch twins (on the
    tensors' own device) for the duration of the block; the trace twins in
    the formulation NR_TRACE_MXU selects. network=False leaves the network
    kernel in place."""
    from neural_renderer_tpu_torch.ops import trace_mxu
    mxu = trace_mxu.use_mxu(None)

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
    if network:
        lane_grid_kernel.forward_lane = lane_twin
    traversal.sweep_shells_dense = \
        lambda *a: trace_pallas.sweep_shells_dense_twin(*a, mxu=mxu)
    trace_cluster.trace_clusters_stream = \
        lambda *a: trace_cluster.trace_clusters_twin(*a, mxu=mxu)
    trace_cluster.sweep_clusters_stream = \
        lambda *a, with_fwd2=False: trace_cluster.sweep_clusters_twin(
            *a, with_fwd2=with_fwd2, mxu=mxu)
    traversal.trace_dense = \
        lambda *a: trace_pallas.trace_dense_twin(*a, mxu=mxu)
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


# Phase 25: the multi-GPU paths. Training's first step against one process:
# K6's own bound on the moments (0.1 x the gradient), the parameters as the
# CPU test (tests/test_torch_parallel_train.py) holds them.
DP_GRAD_TOL = 1e-3         # of max |exp_avg|, K6 against its twin
DP_LOSS_TOL = 0.02         # relative, the step-20 loss against one process
ENTRY_TRACE_SHARE = 0.01   # pixels the "trace" camera entry may change
# 270 rows split into 5 stripes of 54 (4 would leave a remainder, and a
# frame whose height the stripes do not divide falls back to the whole
# frame, as in the JAX package).
EVAL_DP = 5


def run_module(module, argv, timeout=600, keep=lambda line: True):
    """`python -m module argv` from the checkout, in its own process as a
    user runs a multi-rank CLI; logs the lines `keep` accepts and returns
    (stdout, stderr, seconds). Fails unless it exits 0."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    for line in out.stdout.replace("\r", "\n").splitlines():
        if line.strip() and keep(line):
            log("  | " + line)
    for line in out.stderr.splitlines()[-4:]:
        log("  ! " + line)
    if out.returncode != 0:
        raise AssertionError(f"{module} {argv} returned {out.returncode}")
    return out.stdout, out.stderr, time.perf_counter() - t0


def pass_rates(text):
    """{label: Mrays/s} of an evaluate run's two passes."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(Ground truth|Neural): ([0-9.]+) Mrays/s", text, re.M)}


def phase25_denoised(rank, world, device, cfg, size, frames):
    """The ranks of phase 25 (c): the viewer's renderer as `viewer --dp`
    builds it (viewer.build_renderer with a dp mesh) with the denoiser on
    (the viewer's x key; its CLI has no flag for it, as in the JAX
    package), `frames` frames. Rank 0 returns the frames with their
    seconds; every rank its fallback count and its accumulation's pixel
    count."""
    import argparse
    from neural_renderer_tpu_torch import parallel
    from neural_renderer_tpu_torch.cli import viewer
    args = argparse.Namespace(config=cfg, device=str(device), width=size[0],
                              height=size[1], spp=1, ckpt="",
                              mesh=parallel.make_mesh(dp=world, tp=1))
    _, rend, ctl, basis = viewer.build_renderer(args)
    rend.set_camera_basis(basis())
    rend.set_denoise(True)
    out = [(rend.render(ctl.camera.position), rend.last_frame_seconds)
           for _ in range(frames)]
    return (out if rank == 0 else None,
            rend.memory_stats()["tiled_fallback_frames"],
            rend._accum.shape[-1])


def denoise_stitched(accum, count, normals, albedo, n_stripes):
    """bilateral_denoise_tiled's stripes in one process: each stripe's
    [10, rows, W] stack (parallel.shardings.stripe_stack) with its
    neighbours' edge rows as halos (zeros, valid 0, at the frame's border)
    through the same stencil (denoise_ext). Whole-frame inputs; returns the
    u8 image [H, W, 3]."""
    import torch
    from neural_renderer_tpu_torch.ops.denoise import DENOISE_RADIUS as R
    from neural_renderer_tpu_torch.parallel import shardings
    _, h, w = accum.shape
    rows = h // n_stripes
    stacks = [shardings.stripe_stack(
        accum[:, i * rows:(i + 1) * rows], count,
        normals[:, i * rows:(i + 1) * rows],
        albedo[:, i * rows:(i + 1) * rows]) for i in range(n_stripes)]
    out = []
    for i, st in enumerate(stacks):
        zero = torch.zeros_like(st[:, :R])
        up = stacks[i - 1][:, -R:] if i > 0 else zero
        dn = stacks[i + 1][:, :R] if i + 1 < n_stripes else zero
        out.append(shardings.denoise_ext(torch.cat([up, st, dn], dim=1),
                                         rows, w))
    return torch.cat(out, dim=0)


def same_files(dir_a, dir_b, names):
    """{name: whether the two directories' files are byte-equal}."""
    def read(d, n):
        with open(os.path.join(d, n), "rb") as f:
            return f.read()
    return {n: read(dir_a, n) == read(dir_b, n) for n in names}


def npz_arrays(path):
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def parallel_phase(smi, knot7_dir, knot7_text, fresh_loss, trained_loss,
                   dev="cuda", size=(W, H), knot_size=(480, 270),
                   total_samples=None, batch=16384):
    """Phase 25: the multi-GPU paths (see the module docstring).
    knot7_dir / knot7_text: phase 7's output directory and printed text
    (an evaluate of the knot at knot_size); fresh_loss: phase 10's first
    loss from seeded weights; trained_loss: phase 10's loss of the 48k-step
    knot weights. dev, size, knot_size, total_samples (the knot evaluate's)
    and batch (training's) shrink it for a rehearsal on the CPU."""
    import argparse
    import numpy as np
    import torch
    import torch.distributed as dist
    from neural_renderer_tpu_torch import parallel
    from neural_renderer_tpu_torch.cli import evaluate
    from neural_renderer_tpu_torch.cli import train as train_cli
    from neural_renderer_tpu_torch.cli import viewer
    from neural_renderer_tpu_torch.metrics import load_image
    from neural_renderer_tpu_torch.ops import (lane_grid_kernel,
                                               trace_cluster, trace_pallas)
    from neural_renderer_tpu_torch.ops.denoise import bilateral_denoise
    from neural_renderer_tpu_torch.parallel.launch import spawn
    from neural_renderer_tpu_torch.render import neural_march
    from neural_renderer_tpu_torch.render import pathtrace as pt
    from neural_renderer_tpu_torch.render.neural_frame import \
        render_neural_frame
    counters = {"K1": trace_cluster.sweep_clusters_stream,
                "K2": lane_grid_kernel.forward_lane,
                "K3": trace_pallas.trace_dense,
                "K5": trace_cluster.trace_clusters_stream}

    on_gpu = torch.device(dev).type == "cuda"
    W, H = size
    kw, kh = knot_size
    cli_dev = [] if on_gpu else ["--device", "cpu"]
    samples = [] if total_samples is None else ["--total-samples",
                                                str(total_samples)]

    def counted(fn):
        for f in counters.values():
            f.launches = 0
        out = fn()
        if on_gpu:
            torch.cuda.synchronize()
        return out, {k: f.launches for k, f in counters.items()}

    def stitched(parts, whole, w):
        img, acc, guides = whole
        return (torch.equal(torch.cat([p[0] for p in parts]), img)
                and torch.equal(torch.cat([p[1].reshape(3, -1, w)
                                           for p in parts], 1),
                                acc.reshape(3, -1, w))
                and all(torch.equal(torch.cat([p[2][k] for p in parts], 1),
                                    guides[k]) for k in (0, 1)))

    sph_cfg = os.path.join(ROOT, "configs", "sphere", "sphere_lane.json")
    knot_cfg = os.path.join(ROOT, "configs", "knot", "knot_lane.json")
    out_root = os.path.join(ROOT, "comparison_output", "smoke_parallel")

    def renderer(cfg, size):
        _, rend, ctl, basis = viewer.build_renderer(argparse.Namespace(
            config=cfg, device=dev, width=size[0], height=size[1], spp=1,
            ckpt=""))
        rend.set_camera_basis(basis())
        return rend, rend._build_params(ctl.camera.position, 0)

    # (a) stripes in one process ------------------------------------------
    t0 = time.perf_counter()
    srend, sparams = renderer(sph_cfg, (W, H))
    sctx = neural_march.NeuralContext(srend._mesh_tensors("outer_shell"),
                                      srend._mesh_tensors("inner_shell"),
                                      srend.net)
    senv = srend._env_tensors()

    def sphere_frame(row0=0, n_rows=H):
        return render_neural_frame(
            sctx, senv, sparams, torch.zeros((3, W * n_rows), device=dev),
            return_guides=True, row0=row0, n_rows=n_rows)

    whole, la = counted(sphere_frame)
    log(f"[25a sphere {W}x{H} spp1 b3, trained] whole frame launches {la}")
    rows, parts = H // 4, []
    for i in range(4):
        part, la = counted(lambda: sphere_frame(i * rows, rows))
        parts.append(part)
        log(f"[25a sphere stripe {i}: rows {i * rows}-{(i + 1) * rows - 1}] "
            f"launches {la}")
    same = stitched(parts, whole, W)
    log(f"[25a sphere] 4 stripes of {rows} rows equal the whole frame "
        f"(u8 image, accumulation, guides): {same}")
    if not same:
        raise AssertionError("the sphere's stripes differ from its frame")
    acc = whole[1].reshape(3, H, W)
    den = bilateral_denoise(acc, 1, *whole[2])
    den_s = denoise_stitched(acc, 1, *whole[2], 4)
    log(f"[25a denoise {W}x{H}] 4 stripes with halos equal "
        f"bilateral_denoise: {torch.equal(den, den_s)}")
    if not torch.equal(den, den_s):
        raise AssertionError("the tiled denoiser differs from the whole")
    krend, kparams = renderer(knot_cfg, knot_size)
    kgt, kenv = krend._mesh_tensors("original_mesh"), krend._env_tensors()

    def knot_frame(row0=0, n_rows=kh):
        return pt.render_gt_frame(
            kgt, kenv, kparams, torch.zeros((3, kw * n_rows), device=dev),
            return_guides=True, row0=row0, n_rows=n_rows)

    kwhole, la = counted(knot_frame)
    log(f"[25a knot GT {kw}x{kh} spp1 b3] whole frame launches {la}")
    bounds = [kh * i // 4 for i in range(5)]
    kparts = []
    for i in range(4):
        part, la = counted(lambda: knot_frame(bounds[i],
                                              bounds[i + 1] - bounds[i]))
        kparts.append(part)
        log(f"[25a knot stripe {i}: rows {bounds[i]}-{bounds[i + 1] - 1}] "
            f"launches {la}")
    same = stitched(kparts, kwhole, kw)
    log(f"[25a knot] 4 stripes of {[b - a for a, b in zip(bounds, bounds[1:])]}"
        f" rows equal the whole frame: {same} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("the knot's stripes differ from its frame")
    del parts, kparts

    # (b) evaluate --dp over ranks sharing the card -------------------------
    t0 = time.perf_counter()
    ev_dir = out_root + "_evaluate"
    text, err, secs = run_module(
        "neural_renderer_tpu_torch.cli.evaluate",
        [knot_cfg, "--width", str(kw), "--height", str(kh), "--output",
         ev_dir, "--dp", str(EVAL_DP), *samples, *cli_dev],
        keep=lambda ln: " ETA " not in ln)
    psnr, flip = parse_metrics(text)
    same_png = {name: open(os.path.join(ev_dir, name), "rb").read()
                == open(os.path.join(knot7_dir, name), "rb").read()
                for name in ("ground_truth.png", "neural.png",
                             "flip_error.png")}
    rates, rates7 = pass_rates(text), pass_rates(knot7_text)
    metrics7 = parse_metrics(knot7_text)
    log(f"[25b evaluate knot {kw}x{kh} --dp {EVAL_DP} on one card] "
        f"{err.strip()}; PNGs equal phase 7's: {same_png}; PSNR {psnr!r} / "
        f"FLIP {flip!r} (phase 7 {metrics7}); Mrays/s {rates} against one "
        f"process {rates7}; {secs:.1f} s wall ({smi})")
    if not all(same_png.values()) or (psnr, flip) != metrics7:
        raise AssertionError("evaluate --dp differs from phase 7")
    if "falls back" in err:
        raise AssertionError(f"evaluate --dp fell back: {err}")
    # Four stripes need a height 4 divides: 480x272 against one process
    # at that size.
    kh4 = kh + (-kh) % 4
    ev1, ev4 = out_root + "_evaluate272_one", out_root + "_evaluate272_dp4"
    ev_text1 = run_evaluate(evaluate, [
        knot_cfg, "--width", str(kw), "--height", str(kh4), "--output", ev1,
        *samples, *cli_dev])
    text4, err, secs = run_module(
        "neural_renderer_tpu_torch.cli.evaluate",
        [knot_cfg, "--width", str(kw), "--height", str(kh4), "--output",
         ev4, "--dp", "4", *samples, *cli_dev],
        keep=lambda ln: " ETA " not in ln)
    same_png = same_files(ev1, ev4, ("ground_truth.png", "neural.png",
                                     "flip_error.png"))
    log(f"[25b evaluate knot {kw}x{kh4} --dp 4 on one card] {err.strip()}; "
        f"PNGs equal one process's: {same_png}; PSNR / FLIP "
        f"{parse_metrics(text4)} (one process {parse_metrics(ev_text1)}); "
        f"Mrays/s {pass_rates(text4)} against one process "
        f"{pass_rates(ev_text1)}; {secs:.1f} s wall "
        f"({time.perf_counter() - t0:.1f} s for 25b; {smi})")
    if not all(same_png.values()) \
            or parse_metrics(text4) != parse_metrics(ev_text1):
        raise AssertionError("evaluate --dp 4 differs from one process")
    if "falls back" in err:
        raise AssertionError(f"evaluate --dp 4 fell back: {err}")

    # (c) the viewer: `viewer --dp 4` as a user runs it, the denoised
    # renderer on 4 ranks, train-while-render under --dp 2 --------------
    t0 = time.perf_counter()
    vflags = [sph_cfg, "--headless", "2", "--save-sequence", "--width",
              str(W), "--height", str(H), *cli_dev]
    v1, v4 = out_root + "_viewer_one", out_root + "_viewer_dp4"

    def keep_frames(line):
        return line.startswith("frame ")

    vtext1 = run_cli(viewer.main, vflags + ["--output", v1],
                     keep=keep_frames)
    vtext4, err, secs = run_module("neural_renderer_tpu_torch.cli.viewer",
                                   vflags + ["--output", v4, "--dp", "4"],
                                   keep=keep_frames)
    same_png = same_files(v1, v4, ("frame_0000.png", "frame_0001.png",
                                   "viewer_final.png"))
    fps = [[float(v) for v in re.findall(r"([0-9.]+) fps", t)]
           for t in (vtext4, vtext1)]
    log(f"[25c viewer --dp 4 --headless 2 sphere {W}x{H}, 4 ranks on one "
        f"card] {err.strip().splitlines()[0]}; PNGs equal one process's: "
        f"{same_png}; fps 4 ranks {fps[0]} against one process {fps[1]}; "
        f"{secs:.1f} s wall ({smi})")
    if not all(same_png.values()) or "falls back" in err:
        raise AssertionError("viewer --dp 4 differs from one process")
    _, vr, vctl, vbasis = viewer.build_renderer(argparse.Namespace(
        config=sph_cfg, device=dev, width=W, height=H, spp=1, ckpt=""))
    vr.set_camera_basis(vbasis())
    vr.set_denoise(True)
    single = [(vr.render(vctl.camera.position), vr.last_frame_seconds)
              for _ in range(2)]
    del vr
    results = spawn(phase25_denoised, 4, dev, sph_cfg, (W, H), 2,
                    join_timeout=600)
    frames = results[0][0]
    eq = [np.array_equal(a[0], b[0]) for a, b in zip(frames, single)]
    log(f"[25c viewer renderer, denoised, sphere {W}x{H}, 4 ranks on one "
        f"card] frames equal one process: {eq}; fallback frames "
        f"{[r[1] for r in results]}; accumulation pixels per rank "
        f"{[r[2] for r in results]} of {W * H}; frame s 4 ranks "
        f"{[round(f[1], 4) for f in frames]} against one process "
        f"{[round(f[1], 4) for f in single]} ({smi})")
    if not all(eq) or any(r[1] for r in results) \
            or any(r[2] != W * H // 4 for r in results):
        raise AssertionError("the viewer's ranks differ from one process")
    tw, th = knot_size
    live = {}
    for dp in (1, 2):
        argv = [sph_cfg, "--headless", "2", "--train-steps", "2",
                "--train-batch", str(batch), "--width", str(tw),
                "--height", str(th), "--output", f"{out_root}_live{dp}",
                "--train-ckpt-dir", f"{out_root}_live{dp}_ckpt", *cli_dev]
        if dp == 1:
            text = run_cli(viewer.main, argv, keep=keep_frames)
        else:
            text, _, _ = run_module("neural_renderer_tpu_torch.cli.viewer",
                                    argv + ["--dp", "2"], keep=keep_frames)
        live[dp] = ([float(v) for v in re.findall(r"loss ([0-9.]+)", text)],
                    npz_arrays(f"{out_root}_live{dp}_step4.npz"),
                    npz_arrays(f"{out_root}_live{dp}_step4.adam.npz"),
                    load_image(os.path.join(f"{out_root}_live{dp}",
                                            "viewer_final.png")))
    (l1, p1, m1, f1), (l2, p2, m2, f2) = live[1], live[2]
    worst = {name: (float(np.abs(m2[f"exp_avg_{name}"]
                                 - m1[f"exp_avg_{name}"]).max()
                          / np.abs(m1[f"exp_avg_{name}"]).max()),
                    float(np.abs(p2[name] - p1[name]).max()
                          / np.abs(p1[name]).max())) for name in p1}
    step = np.abs(f1.astype(np.int32) - f2.astype(np.int32)).max()
    log(f"[25c train-while-render sphere {tw}x{th}, 2 steps of {batch} a "
        f"frame, --dp 2 against one process] losses {l2} against {l1}; "
        f"per parameter (max |d exp_avg| / max |exp_avg|, max |d param| / "
        f"max |param|) after 4 steps: {worst}; final frames differ by at "
        f"most {int(step)} u8 steps ({time.perf_counter() - t0:.1f} s for "
        f"25c)")
    if len(l1) != 2 or len(l2) != 2 \
            or any(abs(a - b) > DP_LOSS_TOL * a for a, b in zip(l1, l2)) \
            or any(g > DP_GRAD_TOL for g, _ in worst.values()):
        raise AssertionError("train-while-render under --dp strays")

    # (d) train --dp 2 --tp 2 as a user runs it, against one process -----
    t0 = time.perf_counter()
    tr_root = out_root + "_train"
    common = [knot_cfg, "--batch-size", str(batch), "--segments-per-ray",
              "3", "--lr-schedule", "cosine", "--log-every", "1", *cli_dev]

    def keep_train(line):
        return not line.startswith("step ") or " 20/20 " in f" {line}"

    runs = {name: common + ["--steps", str(steps), "--ckpt-dir",
                            os.path.join(tr_root, f"{name}_ckpt")]
            for name, steps in (("one", 1), ("one20", 20))}
    one = {name: run_cli(train_cli.main, argv, keep=keep_train)
           for name, argv in runs.items()}
    texts = []
    for name, steps in (("dptp", 1), ("dptp20", 20)):
        text, err, secs = run_module(
            "neural_renderer_tpu_torch.cli.train",
            common + ["--steps", str(steps), "--dp", "2", "--tp", "2",
                      "--ckpt-dir", os.path.join(tr_root, f"{name}_ckpt")],
            keep=keep_train)
        texts.append(text)
        log(f"[25d train --dp 2 --tp 2 --steps {steps}] {err.strip()}; "
            f"{secs:.1f} s wall")
    worst = {}
    a, b = (npz_arrays(os.path.join(tr_root, f"{n}_step1.adam.npz"))
            for n in ("one", "dptp"))
    pa, pb = (npz_arrays(os.path.join(tr_root, f"{n}_step1.npz"))
              for n in ("one", "dptp"))
    for name in pa:
        ea, eb = a[f"exp_avg_{name}"], b[f"exp_avg_{name}"]
        top = np.abs(ea).max()
        big = np.abs(ea) > DP_GRAD_TOL * top
        worst[name] = (float(np.abs(ea - eb).max() / top),
                       float(np.abs(pa[name] - pb[name])[big].max()
                             / np.abs(pa[name]).max()))
    log(f"[25d train step 1, dp2 x tp2 against one process] per parameter "
        f"(max |d exp_avg| / max |exp_avg|, max |d param| / max |param| "
        f"where |exp_avg| > {DP_GRAD_TOL} x max): {worst}")
    if any(g > DP_GRAD_TOL or p > 1e-6 for g, p in worst.values()):
        raise AssertionError("the dp/tp step differs from one process")
    step_re = r"step 20/20 loss=([0-9.]+).*\(([0-9.]+) Msegments/s\)"
    l1, r1 = (float(v) for v in re.search(step_re, one["one20"]).groups())
    l4, r4 = (float(v) for v in re.search(step_re, texts[1]).groups())
    shard = re.search(r"rank network \+ moment bytes: (.*)",
                      texts[1]).group(1)
    log(f"[25d train 20 steps of {batch} x 3] loss at step 20: dp2 x tp2 "
        f"{l4!r}, one process {l1!r}; steps/s {r4 * 1e6 / batch:.3f} "
        f"against {r1 * 1e6 / batch:.3f}; per rank {shard} ({smi})")
    if abs(l4 - l1) > DP_LOSS_TOL * l1:
        raise AssertionError("the dp/tp loss at step 20 strays")
    ckpt = os.path.join(tr_root, "dptp20_step20.npz")
    text = run_evaluate(evaluate, [
        knot_cfg, "--width", "96", "--height", "54", "--total-samples", "1",
        "--batch-spp", "1", "--ckpt", ckpt, "--output", tr_root + "_eval",
        *cli_dev])
    log(f"[25d] the dp2 x tp2 checkpoint renders: PSNR / FLIP "
        f"{parse_metrics(text)} ({time.perf_counter() - t0:.1f} s for 25d)")

    # (e) NCCL -------------------------------------------------------------
    t0 = time.perf_counter()
    store = os.path.join(out_root + "_nccl", "store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    backend = "nccl" if on_gpu else "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(dp=1)
        acc0 = torch.zeros((3, W * H), device=dev)
        t_img, t_acc, t_g = parallel.render_neural_frame_tiled(
            sctx, senv, sparams, acc0, mesh, return_guides=True)
        k_img, _ = parallel.render_gt_frame_tiled(
            kgt, kenv, kparams, torch.zeros((3, kw * kh), device=dev), mesh)
        t_den = parallel.bilateral_denoise_tiled(t_acc.reshape(3, H, W), 1,
                                                 *t_g, mesh)
        ok = (torch.equal(t_img, whole[0]) and torch.equal(t_acc, whole[1])
              and torch.equal(k_img, kwhole[0]) and torch.equal(t_den, den))
    finally:
        dist.destroy_process_group()
    log(f"[25e {backend} world of 1] tiled sphere, knot GT and denoiser "
        f"equal the plain ones: {ok} ({time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise AssertionError("the NCCL tiled frames differ")
    n_gpu = torch.cuda.device_count() if on_gpu else 0
    if n_gpu >= 4:
        text, err, secs = run_module(
            "neural_renderer_tpu_torch.cli.evaluate",
            [knot_cfg, "--width", str(kw), "--height", str(kh4), "--output",
             out_root + "_nccl", "--dp", "4", *samples],
            keep=lambda ln: " ETA " not in ln)
        same = same_files(ev1, out_root + "_nccl",
                          ("ground_truth.png", "neural.png"))
        log(f"[25e evaluate --dp 4 {kw}x{kh4} over NCCL on 4 GPUs] "
            f"{err.strip()}; PNGs equal one process's: {same}; Mrays/s "
            f"{pass_rates(text)} against one process "
            f"{pass_rates(ev_text1)}")
        if not all(same.values()) or "nccl" not in err:
            raise AssertionError("evaluate over NCCL differs from one "
                                 "process")
    else:
        log(f"[25e] evaluate --dp 4 over NCCL on four GPUs not run: this "
            f"machine has {n_gpu} GPU (NCCL needs a GPU per rank)")

    # (f) the march's "trace" variants -------------------------------------
    t0 = time.perf_counter()
    variants = {}
    for name in ("ENTRY_RETRY_DEFAULT", "CAMERA_ENTRY_DEFAULT"):
        saved = getattr(neural_march, name)
        setattr(neural_march, name, "trace")
        try:
            variants[name], la = counted(lambda: render_neural_frame(
                sctx, senv, sparams, torch.zeros((3, W * H), device=dev)))
        finally:
            setattr(neural_march, name, saved)
        log(f"[25f {name}=trace sphere {W}x{H}] launches {la}")
    retry_same = torch.equal(variants["ENTRY_RETRY_DEFAULT"][0], whole[0])
    differ = (variants["CAMERA_ENTRY_DEFAULT"][0] != whole[0]).any(-1)
    n_diff = int(differ.sum())
    log(f"[25f] NR_ENTRY_RETRY=trace equals derive: {retry_same}; "
        f"NR_CAMERA_ENTRY=trace differs from fwd2 on {n_diff} of {W * H} "
        f"pixels ({n_diff / (W * H):.6f}; max u8 step "
        f"{int((variants['CAMERA_ENTRY_DEFAULT'][0].int() - whole[0].int()).abs().max())}"
        f") ({time.perf_counter() - t0:.1f} s)")
    if not retry_same or n_diff > ENTRY_TRACE_SHARE * W * H:
        raise AssertionError("a march variant strays from the default")

    # (g) resume the JAX package's checkpoint without orbax -----------------
    t0 = time.perf_counter()
    import importlib.util
    has_orbax = importlib.util.find_spec("orbax") is not None
    text = run_cli(train_cli.main, common + [
        "--steps", "48010", "--resume",
        os.path.join(ROOT, "configs", "knot", "lane_step48000.npz"),
        "--ckpt-dir", os.path.join(tr_root, "resume_ckpt")])
    resumed = [float(v) for v in re.findall(r"step 480\d\d/48010 loss="
                                            r"([0-9.]+)", text)]
    log(f"[25g resume lane_step48000.npz (orbax importable here: "
        f"{has_orbax})] losses {resumed}; the 48k weights scored "
        f"{trained_loss!r} in phase 10, a fresh start from the same seed "
        f"{fresh_loss!r} ({time.perf_counter() - t0:.1f} s)")
    if not (len(resumed) == 10 and "from step 48000" in text
            and max(resumed) < 0.03 and resumed[0] < 0.1 * fresh_loss):
        raise AssertionError("the resumed run is not at the checkpoint's "
                             "level")



if __name__ == "__main__":
    sys.exit(main())
