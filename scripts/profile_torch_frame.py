"""Profile the PyTorch port's 1080p frames on one GPU.

    python scripts/profile_torch_frame.py [--weights trained|seeded]
    python scripts/profile_torch_frame.py --knot gt|neural [--spp 8]
    python scripts/profile_torch_frame.py --sphere gt|neural [--spp 8]
    python scripts/profile_torch_frame.py --studio gt|neural|hybrid [--spp 8]
    python scripts/profile_torch_frame.py --train knot|sphere [--batch N]

Default: the chip_smoke.py sphere workload (shelled sphere, lane S=16,
1920x1080, 1 spp, 3 bounces): two warm-up frames, then three frames under
torch.profiler. With --knot: one pass of `evaluate` on
configs/knot/knot_lane.json (ground truth or neural) at 1920x1080, batches
of --spp samples per pixel through the Renderer: one warm-up batch, then
--frames batches under the profiler. --sphere does the same on
configs/sphere/sphere.json (the tcnn-layout network, weights.bin), --studio
on configs/studio/studio_lane.json (neural: without the additional mesh,
as `evaluate --no-additional`; hybrid: with it). Prints
the wall time per frame, the
summed device time of all kernels and the device's idle share over the
window, and the 20 kernels with the largest device time (the port's CUDA
kernels by name, the rest PyTorch's own), then the port's kernels below
them, then the program's own spans (`utils/spans.py`) a frame: each
stage's device ms from its CUDA event pairs, and each host-sync site's
entries beside the runtime's synchronisations. With --train: training steps of
`cli/train.py`'s step function from seeded weights on configs/knot/
knot_lane.json (3 segments per ray) or configs/sphere/sphere_lane.json (1),
--batch segments per step: one warm-up step, --frames steps timed by stage
without the profiler (sampler, then gradient and update, each ended by a
synchronise), then --frames steps under the profiler. Needs a CUDA device;
no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", choices=("trained", "seeded"),
                    default="trained")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--knot", choices=("gt", "neural"), default=None)
    ap.add_argument("--sphere", choices=("gt", "neural"), default=None)
    ap.add_argument("--studio", choices=("gt", "neural", "hybrid"),
                    default=None)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--train", choices=("knot", "sphere"), default=None)
    ap.add_argument("--batch", type=int, default=262144)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_frame: needs a CUDA device")
    sys.path.insert(0, ROOT)
    from neural_renderer_tpu_torch.models import convert, nbvh
    from neural_renderer_tpu_torch.render.neural_frame import \
        render_neural_frame
    from neural_renderer_tpu_torch.render.neural_march import NeuralContext
    from neural_renderer_tpu_torch.render.params import RenderParams
    from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
    from neural_renderer_tpu_torch.scene.materials import Material
    from neural_renderer_tpu_torch.scene.mesh import outward_sphere

    dev = torch.device("cuda")
    w, h = 1920, 1080
    if args.train:
        step, segments, _ = train_step(args.train, args.batch, args.frames,
                                       dev)
        report(profile_frames(step, 1, args.frames), args.frames,
               f"train {args.train}, {args.batch} segments x "
               f"{segments} per ray per step")
        return
    for scene, which, cfg_name in (("knot", args.knot, "knot_lane.json"),
                                   ("sphere", args.sphere, "sphere.json"),
                                   ("studio", args.studio,
                                    "studio_lane.json")):
        if which:
            render = evaluate_pass(scene, cfg_name, which, args.spp, w, h,
                                   dev)
            report(profile_frames(render, 1, args.frames), args.frames,
                   f"{cfg_name} {which} pass, {args.spp} spp per batch")
            return
    outer_h = outward_sphere(24, 48, 1.15)
    cfg = nbvh.NbvhConfig(grid_type="lane", lane_sublanes=16,
                          lane_entry_pack=2)
    if args.weights == "trained":
        net = convert.params_from_numpy(convert.load_params_npz(
            os.path.join(ROOT, "configs", "sphere",
                         "lane16_step24000.npz")), cfg, device=dev)
    else:
        net = nbvh.init_params(cfg, torch.Generator().manual_seed(0), dev)
    ctx = NeuralContext(outer_h.to_tensors(dev),
                        outward_sphere(24, 48, 0.85).to_tensors(dev), net)
    env = EnvironmentTensors.from_numpy(None, device=dev)
    omin, omax = outer_h.bounds()

    def params(offset):
        return RenderParams.make(
            w, h, 1, 3, [0.0, 0.0, 3.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0], 0.9, Material.default(),
            sample_offset=offset, scene_scale=2.0, outer_shell_min=omin,
            outer_shell_inv_extent=1.0 / (omax - omin), device=dev)

    state = {"accum": torch.zeros((3, w * h), device=dev), "i": 0}

    def render():
        _, state["accum"] = render_neural_frame(ctx, env, params(state["i"]),
                                                state["accum"])
        state["i"] += 1

    report(profile_frames(render, 2, args.frames), args.frames,
           f"weights {args.weights}")


def evaluate_pass(scene, cfg_name, which, spp, w, h, dev):
    """`render()` that runs one batch of configs/<scene>/<cfg_name>'s
    ground-truth ("gt"), neural or hybrid pass as `evaluate` does (the
    neural pass without the additional mesh, the hybrid one with it)."""
    from neural_renderer_tpu_torch import config as nr_config
    from neural_renderer_tpu_torch.render.renderer import (RenderBasis,
                                                           Renderer)
    from neural_renderer_tpu_torch.scene.scene import Scene
    cfg = nr_config.load_config(os.path.join(ROOT, "configs", scene,
                                             cfg_name))
    renderer = Renderer(Scene.from_config(cfg),
                        cfg.neural_network, device=dev)
    if not renderer.load_weights_from_file(cfg.checkpoint_path):
        sys.exit(f"profile_torch_frame: {cfg_name} weights missing")
    pos, yaw, pitch = nr_config.matrix_to_camera_state(cfg.camera.matrix)
    renderer.set_camera_basis(RenderBasis(
        *nr_config.camera_basis_from_state(yaw, pitch, cfg.camera.yfov)))
    renderer.resize(w, h)
    renderer.set_bounce_count(cfg.rendering.bounce_count)
    renderer.set_use_neural_query(which != "gt")
    renderer.set_use_additional_mesh(which == "hybrid")
    return lambda: renderer.render_accumulate(pos, spp, batch_spp=spp)


def train_step(scene_name, batch, frames, dev):
    """(`step()` running one training step as cli/train.py does, segments
    per ray, timings). Before returning, runs one warm-up step and times
    `frames` steps by stage: the sampler and the gradient + update, each
    ended by a synchronise; timings = {"msegments_s", "sample_ms",
    "grad_ms"} per step. chip_smoke.py phase 11 calls this."""
    import torch
    from neural_renderer_tpu_torch import config as nr_config
    from neural_renderer_tpu_torch.models import nbvh
    from neural_renderer_tpu_torch.scene.scene import Scene
    from neural_renderer_tpu_torch.train import (
        TrainConfig, init_train_state, make_train_step_on_batch,
        sample_segment_batch, scene_global_row, segment_domain)
    from neural_renderer_tpu_torch.utils import spans
    name = {"knot": "knot_lane.json", "sphere": "sphere_lane.json"}
    cfg = nr_config.load_config(os.path.join(ROOT, "configs", scene_name,
                                             name[scene_name]))
    scene = Scene.from_config(cfg)
    net_config = nbvh.NbvhConfig.from_network_config(cfg.neural_network)
    segments = 3 if scene_name == "knot" else 1
    tcfg = TrainConfig(batch_size=batch, steps=1000, lr_schedule="cosine",
                       segments_per_ray=segments)
    meshes = [getattr(scene, m).to_tensors(dev) for m in
              ("original_mesh", "outer_shell", "inner_shell")]
    omin, inv, radius = segment_domain(scene, dev)
    row = scene_global_row(scene, dev)
    state = init_train_state(tcfg, net_config, dev)
    grad_step = make_train_step_on_batch(tcfg, net_config, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def sample():
        # Named as make_train_step names its sampler.
        with torch.no_grad(), spans.span("sampleSegments"):
            return sample_segment_batch(gen, *meshes, omin, inv, batch,
                                        radius, segments, global_row=row)

    def step():
        grad_step(state, sample())

    step()
    torch.cuda.synchronize()
    t_sample = t_grad = 0.0
    for _ in range(frames):
        t0 = time.perf_counter()
        b = sample()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, m = grad_step(state, b)
        torch.cuda.synchronize()
        t_grad += time.perf_counter() - t1
        t_sample += t1 - t0
    timings = {"msegments_s": batch * frames / (t_sample + t_grad) / 1e6,
               "sample_ms": t_sample * 1e3 / frames,
               "grad_ms": t_grad * 1e3 / frames}
    print(f"train {scene_name}: {frames} steps of {batch} segments x "
          f"{segments} per ray, sampler {timings['sample_ms']:.3f} ms/step, "
          f"gradient + update {timings['grad_ms']:.3f} ms/step, "
          f"{timings['msegments_s']!r} Msegments/s (stages synchronised), "
          f"loss {float(m['total']):.4f}", flush=True)
    return step, segments, timings


def profile_frames(render, warmup, frames):
    """(wall seconds, profiler) over `frames` calls of render() after
    `warmup` unprofiled ones; the program's spans hold those calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neural_renderer_tpu_torch.utils import spans
    for _ in range(warmup):
        render()
    torch.cuda.synchronize()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof


def report(result, frames, label):
    import torch
    wall, prof = result
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"device {torch.cuda.get_device_name(0)}; {label}; {frames} "
          f"frames; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    print(f"wall ms/frame {wall * 1e3 / frames:.3f}; device kernel "
          f"ms/frame {dev_us / 1e3 / frames:.3f}; idle share "
          f"{1.0 - dev_us / 1e6 / wall:.3f} (profiler on)")
    # The port's own kernels: every name that is not PyTorch's, cub's or a
    # copy.
    def ported(e):
        return not ("at::" in e.key or "cub::" in e.key
                    or e.key.startswith(("Memcpy", "Memset")))

    port_us = sum(e.self_device_time_total for e in events if ported(e))
    print(f"port kernels device ms/frame {port_us / 1e3 / frames:.3f}; "
          f"PyTorch ops and copies {(dev_us - port_us) / 1e3 / frames:.3f}")
    print(f"{'kernel':60s} {'calls/frame':>11s} {'device ms/frame':>15s}")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # The 20 largest, then the port's own kernels below them.
    for i, e in enumerate(ranked):
        if i >= 20 and not ported(e):
            continue
        print(f"{e.key[:60]:60s} {e.count / frames:11.1f} "
              f"{e.self_device_time_total / 1e3 / frames:15.3f}")
    report_spans(prof, frames)


# The runtime calls that make the host wait for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def report_spans(prof, frames):
    """The program's spans a frame (`utils/spans.py`, recorded while the
    profiler ran): the calls of the frame or step and of each stage, each
    stage's device ms, each sync site's entries, and the runtime's
    synchronisations of the window."""
    from neural_renderer_tpu_torch.utils import spans
    got = spans.totals()["spans"]
    print(f"{'span':24s} {'calls/frame':>11s} {'device ms/frame':>15s}")
    for name in sorted(n for n in got if not n.startswith(spans.SYNC)):
        s = got[name]
        ms = "n/a" if s["device_s"] is None else \
            f"{s['device_s'] * 1e3 / frames:.3f}"
        print(f"{name:24s} {s['calls'] / frames:11.1f} {ms:>15s}")
    syncs = sum(e.count for e in prof.key_averages() if e.key in SYNC_CALLS)
    print(f"host syncs a frame: {syncs / frames:.1f} (runtime); by site:")
    for name in sorted(n for n in got if n.startswith(spans.SYNC)):
        print(f"  {name:30s} {got[name]['calls'] / frames:11.1f}")


if __name__ == "__main__":
    main()
