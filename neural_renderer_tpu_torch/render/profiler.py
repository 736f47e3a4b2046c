"""Stage-timing harness: the reference's per-kernel timing table.

Port of `neural_renderer_tpu/render/profiler.py`: the 13 KernelId
categories, `KernelTimings` with its table (ms and ns per ray), and the
stage profiles of both branches. The stages run one by one, as the frame
calls them (`pathtrace`, `neural_march`, `neural_frame`), each timed over
`runs` calls after one warm-up call: on the GPU between a pair of CUDA
events, then synchronised; on the CPU by the host clock. `frame_total_ms`
is the whole frame timed the same way. The category sum may exceed it
(the stages write their intermediates out and the bounce stages run on the
full batch, where the frame compacts). The JAX harness subtracts a remote
platform's round-trip floor; nothing here needs one. The neural profile's
"avg neural calls/ray" is the live rows the network was handed
(`net_rows`, utils/spans.py) in one more, untimed frame, over its rays.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import torch

from ..models import nbvh
from ..ops import traversal
from ..utils import spans
from ..utils.spans import CATEGORIES
from . import pathtrace as pt
from .neural_frame import render_neural_frame
from .neural_march import (NeuralContext, bounce_shell_entry_and_early_term,
                           trace_neural_segments)


@dataclass
class KernelTimings:
    """Per-category ms of one frame, its ray count, the live rows it
    handed the network (neural profiles) and the frame's own time."""
    ms: dict = field(default_factory=lambda: {k: 0.0 for k in CATEGORIES})
    ray_count: int = 0
    neural_ray_calls: int = 0
    frame_total_ms: float = 0.0

    def ns_per_ray(self, category: str) -> float:
        if self.ray_count == 0:
            return 0.0
        return self.ms[category] * 1e6 / self.ray_count

    @property
    def mrays(self) -> float:
        return self.ray_count / 1e6

    @property
    def neural_calls_per_ray(self) -> float:
        return self.neural_ray_calls / max(1, self.ray_count)

    def table(self) -> str:
        lines = [f"{'category':24s} {'ms':>9s} {'ns/ray':>9s}"]
        for k in CATEGORIES:
            if self.ms[k] > 0:
                lines.append(f"{k:24s} {self.ms[k]:9.3f} "
                             f"{self.ns_per_ray(k):9.2f}")
        lines.append(f"{'frame total':24s} {self.frame_total_ms:9.3f} "
                     f"{self.frame_total_ms * 1e6 / max(1, self.ray_count):9.2f}")
        lines.append(f"rays/frame: {self.mrays:.2f} M   "
                     f"avg neural calls/ray: {self.neural_calls_per_ray:.2f}")
        return "\n".join(lines)


def _timer(device, runs: int):
    """timed(fn, *args) -> (last output, ms per call) of fn(*args) over
    `runs` calls after one warm-up call, on `device`'s clock."""
    @torch.no_grad()
    def timed(fn, *args):
        out = fn(*args)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(runs):
                out = fn(*args)
            end.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(end) / runs
        t0 = time.perf_counter()
        for _ in range(runs):
            out = fn(*args)
        return out, (time.perf_counter() - t0) * 1e3 / runs
    return timed


@torch.no_grad()
def _net_rows(fn, *args) -> int:
    """The live rows one untimed call fn(*args) hands the network: the
    `net_rows` counter, which records while the torch profiler does."""
    before = spans.totals()["counts"].get("net_rows", 0)
    if torch.autograd._profiler_enabled():
        fn(*args)
    else:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            fn(*args)
    return spans.totals()["counts"].get("net_rows", 0) - before


def profile_renderer(renderer, cam_pos, neural: bool,
                     runs: int = 2) -> KernelTimings:
    """Stage-profile a Renderer's current scene and settings: the harness
    the viewer's `t` key and `evaluate --profile` share."""
    params = renderer._build_params(cam_pos, renderer.accum_sample_count)
    env = renderer._env_tensors()
    if neural and renderer.scene.outer_shell.num_triangles:
        if renderer.net is None:
            raise RuntimeError("neural profile without weights")
        ctx = NeuralContext(outer=renderer._mesh_tensors("outer_shell"),
                            inner=renderer._mesh_tensors("inner_shell"),
                            net=renderer.net)
        use_add = (renderer.use_additional_mesh
                   and renderer.scene.additional_mesh.num_triangles > 0)
        add = renderer._mesh_tensors("additional_mesh") if use_add else None
        return profile_neural_frame(ctx, add, env, params,
                                    use_additional=use_add, runs=runs)
    return profile_gt_frame(renderer._mesh_tensors(renderer._classic_name()),
                            env, params, runs=runs)


def _bounce_loop(timed, t, params, env, path, hits, pixel_idx, sample_of,
                 stage):
    """The bounces of either branch: sampling, `stage(rays, path) ->
    (bounce_hits, path)` (the branch's traces, which fill their own
    categories) and integration."""
    incoming = None
    cur_hits = hits
    for bounce in range(1, params.max_bounces + 1):
        (rays, active), ms = timed(
            lambda p, h, a, inc: pt.sample_bounce(
                p, pixel_idx, sample_of, h, a, inc),
            params, cur_hits, path.active, incoming)
        t.ms["sampleBounce"] += ms
        path = path._replace(active=active)
        bh, path = stage(rays, path)
        path, ms = timed(
            lambda p, pa, b, r, bi=bounce: pt.integrate_bounce(
                p, env, pa, b, r, bi, pixel_idx, sample_of),
            params, path, bh, rays)
        t.ms["integrateBounce"] += ms
        incoming, cur_hits = rays.direction, bh
    return path


def profile_gt_frame(mesh, env, params, accum=None,
                     runs=2) -> KernelTimings:
    """Per-stage timings of the ground-truth branch."""
    timed = _timer(params.device, runs)
    t = KernelTimings()
    t.ray_count = params.height * params.width * params.samples_per_pixel
    if accum is None:
        accum = torch.zeros((3, params.height * params.width),
                            device=params.device)
    (pixel_idx, sample_of, _, origins, dirs), _ = timed(
        pt.primary_rays, params)
    hits, t.ms["primaryTrace"] = timed(pt.trace_primary_gt, mesh, params,
                                        origins, dirs)
    path, t.ms["initPathState"] = timed(pt.init_path_state, params, env,
                                         hits, dirs)

    def stage(rays, path):
        bh, ms = timed(pt.trace_bounces_gt, mesh, params, rays)
        t.ms["bounceTrace"] += ms
        return bh, path

    path = _bounce_loop(timed, t, params, env, path, hits, pixel_idx,
                        sample_of, stage)
    _, t.ms["finalize"] = timed(pt.finalize, params, path.radiance, accum)
    _, t.frame_total_ms = timed(pt.render_gt_frame, mesh, env, params,
                                 accum)
    return t


def profile_neural_frame(ctx: NeuralContext, additional_mesh, env, params,
                         accum=None, use_additional=False,
                         runs=2) -> KernelTimings:
    """Per-stage timings of the neural branch. The shell march (sweeps and
    network) is one stage, reported under shellTrace; neuralForward is a
    standalone network call at the march's ray count (one iteration's
    worth of network work)."""
    timed = _timer(params.device, runs)
    t = KernelTimings()
    n = params.height * params.width * params.samples_per_pixel
    t.ray_count = n
    if accum is None:
        accum = torch.zeros((3, params.height * params.width),
                            device=params.device)
    add = additional_mesh if (use_additional and additional_mesh is not None
                              and not additional_mesh.is_empty) else None
    (pixel_idx, sample_of, _, origins, dirs), _ = timed(
        pt.primary_rays, params)
    hits, t.ms["shellTrace"] = timed(trace_neural_segments, ctx, params,
                                      origins, dirs)
    net_in = torch.zeros((12, n), device=params.device)
    _, t.ms["neuralForward"] = timed(nbvh.apply, ctx.net, net_in)

    if add is not None:
        add_hits, t.ms["additionalMeshPrimary"] = timed(
            pt.trace_rays_mesh, add, params, origins, dirs,
            traversal.FORWARD_ONLY)
        hits, t.ms["selectClosestPrimary"] = timed(
            pt.select_closest_hits, params, hits, add_hits, origins)
    path, t.ms["initPathState"] = timed(pt.init_path_state, params, env,
                                         hits, dirs)

    def stage(rays, path):
        # The frame fuses early termination and the shell entry into one
        # sweep: that stage is earlyTermination, the march from it
        # shellTrace.
        (active, entry), ms = timed(bounce_shell_entry_and_early_term, ctx,
                                     rays, path.active)
        t.ms["earlyTermination"] += ms
        path = path._replace(active=active)
        bh, ms = timed(
            lambda c, p, r, e: trace_neural_segments(
                c, p, r.origin, r.direction, entry=e),
            ctx, params, rays, entry)
        t.ms["shellTrace"] += ms
        if add is not None:
            add_hits, ms = timed(
                lambda m, p, r: pt.trace_rays_mesh(
                    m, p, r.origin, r.direction, traversal.ANY,
                    active=r.pdf > 0.0),
                add, params, rays)
            t.ms["additionalMeshBounce"] += ms
            bh, ms = timed(pt.select_closest_hits, params, bh, add_hits,
                            rays.origin)
            t.ms["selectClosestBounce"] += ms
        return bh, path

    path = _bounce_loop(timed, t, params, env, path, hits, pixel_idx,
                        sample_of, stage)
    _, t.ms["finalize"] = timed(pt.finalize, params, path.radiance, accum)
    def frame(c, e, p, a):
        return render_neural_frame(c, e, p, a, use_additional=add is not None,
                                   additional_mesh=add)

    _, t.frame_total_ms = timed(frame, ctx, env, params, accum)
    t.neural_ray_calls = _net_rows(frame, ctx, env, params, accum)
    return t


def profile_neural_frame_by_bounce(ctx: NeuralContext, additional_mesh, env,
                                   params, use_additional=False,
                                   runs=2) -> dict:
    """The whole frame's time at max_bounces = 0..params.max_bounces: the
    increment between consecutive bounce counts is what that bounce costs
    inside the frame (its compaction, sorting and traces). Returns
    {"frame_ms": [ms at b=0, ...], "bounce_ms": [increment of bounce 1,
    ...], "ray_count": n}."""
    timed = _timer(params.device, runs)
    add = additional_mesh if use_additional else None
    accum = torch.zeros((3, params.height * params.width),
                        device=params.device)
    frame_ms = []
    for b in range(params.max_bounces + 1):
        p = dataclasses.replace(params, max_bounces=b)
        _, ms = timed(
            lambda c, e, pp, a: render_neural_frame(
                c, e, pp, a, use_additional=add is not None,
                additional_mesh=add),
            ctx, env, p, accum)
        frame_ms.append(ms)
    return {
        "frame_ms": frame_ms,
        "bounce_ms": [frame_ms[i] - frame_ms[i - 1]
                      for i in range(1, len(frame_ms))],
        "ray_count": params.height * params.width * params.samples_per_pixel,
    }
