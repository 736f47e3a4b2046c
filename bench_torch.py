"""Benchmark of the PyTorch/CUDA port: neural-render throughput at 1080p.

Prints, as its last line, one JSON object of bench.py's shape:
  {"metric": "...", "value": N, "unit": "Mrays/s", "vs_baseline": N,
   "repeats": R, "min": N, "max": N}

The workload is bench.py's, through the port (neural_renderer_tpu_torch):
render/neural_frame.py::render_neural_frame on the shelled-sphere scene
(outward UV spheres: original 48 x 96, inner 24 x 48 at 0.85, outer 24 x 48
at 1.15), camera at (0, 0, 3), fov 0.9, the default material and sky,
seeded network weights (a torch.Generator seeded 0), or
render/pathtrace.py::render_gt_frame under BENCH_MODE=gt. Rays are counted
as bench.py counts them: width x height x spp per frame. `value` is the
median Mrays/s of BENCH_REPEATS timed blocks of BENCH_FRAMES frames, each
ending in torch.cuda.synchronize(), after one warm-up frame; `min` and
`max` are their spread.

vs_baseline = Mrays/s / (10 x the port's own CPU Mrays/s), bench.py's
self-relative target: the CPU run is this script at 192x108, one frame,
in a subprocess that asks for the CPU (BENCH_DEVICE=cpu), cached in
bench_torch_cpu_baseline.json (not bench_cpu_baseline.json, which holds the
JAX pipeline's). BENCH_SKIP_CPU=1 skips it (vs_baseline 1.0).

Knobs, as bench.py's: BENCH_WIDTH/HEIGHT/SPP/BOUNCES/FRAMES/REPEATS,
BENCH_GRID=lane|tcnn, BENCH_LANE_SUBLANES (16), BENCH_SCENE=sphere|knot,
BENCH_MODE=neural|gt, BENCH_SKIP_CPU=1; BENCH_DEVICE=cpu runs on the CPU
(the default is the GPU, and without one the script exits 2).
BENCH_ADDITIONAL_TRIS > 0 (bench.py's hybrid additional mesh) exits 3: the
hybrid branch is not ported.

    python bench_torch.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CPU_CACHE = os.path.join(ROOT, "bench_torch_cpu_baseline.json")


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def build_scene():
    """(original, inner, outer) HostMeshes of bench.py's scene."""
    from neural_renderer_tpu_torch.scene.mesh import outward_sphere
    from neural_renderer_tpu_torch.scene.mesh_loader import load_mesh_auto
    if os.environ.get("BENCH_SCENE", "sphere") == "knot":
        base = os.path.join(ROOT, "configs", "knot")
        return tuple(load_mesh_auto(os.path.join(base, f"{name}.obj"))
                     for name in ("original", "inner", "outer"))
    return (outward_sphere(48, 96, 1.0), outward_sphere(24, 48, 0.85),
            outward_sphere(24, 48, 1.15))


def make_frame_fn(device, width, height, spp, bounces):
    """(run(accum, sample_offset) -> (image, accum), accum0) of bench.py's
    frame through the port."""
    import torch

    from neural_renderer_tpu_torch.models import nbvh
    from neural_renderer_tpu_torch.render import neural_frame, pathtrace
    from neural_renderer_tpu_torch.render.neural_march import NeuralContext
    from neural_renderer_tpu_torch.render.params import RenderParams
    from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
    from neural_renderer_tpu_torch.scene.materials import Material

    original, inner, outer = build_scene()
    env = EnvironmentTensors.from_numpy(None, device=device)
    omin, omax = outer.bounds()
    knot = os.environ.get("BENCH_SCENE", "sphere") == "knot"

    def params(offset):
        return RenderParams.make(
            width=width, height=height, samples_per_pixel=spp,
            max_bounces=bounces, cam_pos=[0.0, 0.0, 7.0 if knot else 3.0],
            cam_forward=[0.0, 0.0, -1.0], cam_right=[1.0, 0.0, 0.0],
            cam_up=[0.0, 1.0, 0.0], fov_y=0.9, material=Material.default(),
            sample_offset=offset,
            scene_scale=float(np.linalg.norm(omax - omin)) if knot else 2.0,
            outer_shell_min=omin, outer_shell_inv_extent=1.0 / (omax - omin),
            device=device)

    accum0 = torch.zeros((3, width * height), device=device)
    if os.environ.get("BENCH_MODE", "neural") == "gt":
        mesh = original.to_tensors(device)
        return (lambda accum, offset: pathtrace.render_gt_frame(
            mesh, env, params(offset), accum)), accum0

    grid = os.environ.get("BENCH_GRID", "lane")
    cfg = (nbvh.NbvhConfig(grid_type="lane",
                           lane_sublanes=env_int("BENCH_LANE_SUBLANES", 16))
           if grid == "lane" else nbvh.NbvhConfig(grid_type="tcnn"))
    net = nbvh.init_params(cfg, torch.Generator().manual_seed(0), device)
    ctx = NeuralContext(outer.to_tensors(device), inner.to_tensors(device),
                        net)
    return (lambda accum, offset: neural_frame.render_neural_frame(
        ctx, env, params(offset), accum)), accum0


def measure(device, width, height, spp, bounces, frames, repeats=1):
    """Mrays/s of each of `repeats` timed blocks of `frames` frames, after
    one warm-up frame; each block ends in a device synchronisation."""
    import torch
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    run, accum = make_frame_fn(device, width, height, spp, bounces)
    _, accum = run(accum, 0)
    sync()
    samples, offset = [], spp
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(frames):
            _, accum = run(accum, offset)
            offset += spp
        sync()
        samples.append(width * height * spp * frames
                       / (time.perf_counter() - t0) / 1e6)
    return samples


def cpu_baseline_mrays(bounces: int, workload: str) -> float | None:
    """The port's CPU Mrays/s on this frame at 192x108 (one frame, in a
    subprocess with BENCH_DEVICE=cpu), cached per `workload` (mode, bounces,
    grid and scene)."""
    if os.environ.get("BENCH_SKIP_CPU") == "1":
        return None
    try:
        with open(CPU_CACHE) as f:
            data = json.load(f)
        if data.get("workload") == workload:
            return float(data["cpu_mrays"])
    except (OSError, ValueError, KeyError):
        pass
    env = dict(os.environ, BENCH_DEVICE="cpu", BENCH_SKIP_CPU="1",
               BENCH_WIDTH="192", BENCH_HEIGHT="108", BENCH_SPP="1",
               BENCH_BOUNCES=str(bounces), BENCH_FRAMES="1",
               BENCH_REPEATS="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__)],
                          env=env, capture_output=True, text=True,
                          timeout=3600)
    if proc.returncode != 0:
        print(f"CPU baseline failed (rc {proc.returncode}): "
              f"{proc.stderr[-500:]}", file=sys.stderr)
        return None
    mrays = float(json.loads(proc.stdout.strip().splitlines()[-1])["value"])
    with open(CPU_CACHE, "w") as f:
        json.dump({"cpu_mrays": mrays, "workload": workload,
                   "size": "192x108 spp1, the port on the CPU"}, f)
    return mrays


def main() -> int:
    import torch
    add_tris = env_int("BENCH_ADDITIONAL_TRIS", 0)
    if add_tris > 0:
        print("bench_torch: BENCH_ADDITIONAL_TRIS needs the hybrid "
              "additional-mesh branch, which the port does not have yet",
              file=sys.stderr)
        return 3
    if os.environ.get("BENCH_DEVICE") == "cpu":
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        print("bench_torch: no CUDA device (BENCH_DEVICE=cpu runs on the "
              "CPU)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    width, height = env_int("BENCH_WIDTH", 1920), env_int("BENCH_HEIGHT",
                                                          1080)
    spp, bounces = env_int("BENCH_SPP", 1), env_int("BENCH_BOUNCES", 3)
    samples = sorted(measure(device, width, height, spp, bounces,
                             env_int("BENCH_FRAMES", 4),
                             env_int("BENCH_REPEATS", 3)))
    mid = len(samples) // 2
    mrays = samples[mid] if len(samples) % 2 else 0.5 * (samples[mid - 1]
                                                         + samples[mid])
    grid = os.environ.get("BENCH_GRID", "lane")
    scene = os.environ.get("BENCH_SCENE", "sphere")
    extra = f" {scene}" if scene != "sphere" else ""
    mode = "gt" if os.environ.get("BENCH_MODE", "neural") == "gt" else \
        "neural"
    cpu = (cpu_baseline_mrays(bounces, f"{mode} b{bounces} {grid} {scene}")
           if device.type == "cuda" else None)
    print(json.dumps({
        "metric": f"{mode} render Mrays/s @ {width}x{height} spp{spp} "
                  f"b{bounces} {grid}{extra} ({device.type})",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / (10.0 * cpu) if cpu else 1.0,
        "repeats": len(samples),
        "min": samples[0],
        "max": samples[-1],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
