"""The port's spans and counters (`utils/spans.py`), on the CPU.

Off, a span is one shared no-op and nothing is recorded. On (under
torch.profiler), a tiny neural frame and a tiny ground-truth frame carry
their stage and sync spans, nested as the frames run them; `net_rows`
counts exactly the live rows handed to `models/nbvh.py::apply`; and the
image and accumulation are bit for bit those of the untraced frame. The
neural frame has 64x64 rays, the fewest that take the march's and the
bounce's compaction, between shells of two spheres one behind the other,
so that camera rays march a second segment.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from neural_renderer_tpu_torch.models import nbvh
from neural_renderer_tpu_torch.render import pathtrace as pt
from neural_renderer_tpu_torch.render.neural_frame import render_neural_frame
from neural_renderer_tpu_torch.render.neural_march import NeuralContext
from neural_renderer_tpu_torch.render.params import RenderParams
from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
from neural_renderer_tpu_torch.scene.materials import Material
from neural_renderer_tpu_torch.scene.mesh import HostMesh, outward_sphere
from neural_renderer_tpu_torch.utils import spans

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

_CAM = dict(cam_pos=[0, 0, 3.0], cam_forward=[0, 0, -1.0],
            cam_right=[1, 0, 0.0], cam_up=[0, 1, 0.0], fov_y=0.8,
            scene_scale=2.0)


def _two_spheres(radius: float) -> HostMesh:
    """Two spheres of `radius` on the z axis, at z = +0.7 and -0.7."""
    a = outward_sphere(6, 12, radius)
    n = a.vertices.shape[0]
    return HostMesh(
        vertices=np.concatenate([a.vertices + [0, 0, 0.7],
                                 a.vertices - [0, 0, 0.7]]).astype(
                                     np.float32),
        indices=np.concatenate([a.indices, a.indices + n]).astype(np.uint32))


@pytest.fixture(scope="module")
def scene():
    outer, inner = _two_spheres(0.6), _two_spheres(0.3)
    net = nbvh.init_params(nbvh.NbvhConfig(grid_type="lane",
                                           lane_sublanes=4),
                           torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        # Tables large enough that presence takes both signs.
        net.lane.mul_(1e3)
    ctx = NeuralContext(outer.to_tensors("cpu"), inner.to_tensors("cpu"),
                        net)
    omin, omax = outer.bounds()
    bounds = dict(outer_shell_min=omin,
                  outer_shell_inv_extent=1.0 / (omax - omin))
    return ctx, outer.to_tensors("cpu"), bounds


def _env():
    return EnvironmentTensors.from_numpy(None, device="cpu")


def _neural(scene):
    ctx, _, bounds = scene
    p = RenderParams.make(64, 64, 1, 2, material=Material(roughness=0.5),
                          device="cpu", **_CAM, **bounds)
    accum = torch.zeros((3, 64 * 64))
    return lambda: render_neural_frame(ctx, _env(), p, accum)


def _gt(scene):
    _, mesh, _ = scene
    p = RenderParams.make(24, 16, 1, 3, material=Material(roughness=0.5),
                          device="cpu", **_CAM)
    accum = torch.zeros((3, 24 * 16))
    return lambda: pt.render_gt_frame(mesh, _env(), p, accum)


def _traced(fn):
    """(fn()'s output, the nr.* ranges [(name, start, end)], totals()) of
    one call under torch.profiler."""
    spans.reset()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name()[len(spans.PREFIX):], e.start_ns(),
               e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(spans.PREFIX)]
    return out, ranges, spans.totals()


def _nested(ranges, child, parent) -> bool:
    """Every `child` range lies inside a `parent` range (and there is
    one)."""
    kids = [(s, e) for n, s, e in ranges if n == child]
    outer = [(s, e) for n, s, e in ranges if n == parent]
    return bool(kids) and all(any(ps <= s and e <= pe for ps, pe in outer)
                              for s, e in kids)


def test_off_a_span_is_one_shared_no_op_and_records_nothing(scene):
    spans.reset()
    assert not torch.autograd._profiler_enabled()
    off = spans.span("frame")
    assert off is spans.span("sync.image") is spans.span("shellTrace")
    with off as inner:
        assert inner is off
    spans.count("net_rows", 7)
    spans.count("net_rows", torch.tensor(3))
    _neural(scene)()
    assert spans.totals() == {"spans": {}, "counts": {}}


def test_on_spans_count_calls_and_counters_add():
    spans.reset()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with spans.span("shellTrace"), spans.span("sync.marchActive"):
                pass
        spans.count("net_rows", 5)
        spans.count("net_rows", torch.tensor([True, False, True]).sum())
    got = spans.totals()
    # No CUDA here: a stage records no event pair.
    assert got["spans"] == {"shellTrace": {"calls": 3, "device_s": None},
                            "sync.marchActive": {"calls": 3,
                                                 "device_s": None}}
    assert got["counts"] == {"net_rows": 7}
    assert spans.totals() == got
    spans.reset()
    assert spans.totals() == {"spans": {}, "counts": {}}


def test_neural_frame_spans_rows_and_image(scene, monkeypatch):
    frame = _neural(scene)
    img0, accum0 = frame()
    rows = []
    real = nbvh.apply

    def spy(net, inputs, active=None):
        rows.append(inputs.shape[1] if active is None
                    else int(active.sum()))
        return real(net, inputs, active=active)

    monkeypatch.setattr(nbvh, "apply", spy)
    (img1, accum1), ranges, got = _traced(frame)
    assert torch.equal(img0, img1) and torch.equal(accum0, accum1)
    assert (img0 != img0[0, 0]).any()
    assert got["counts"] == {"net_rows": sum(rows)} and sum(rows) > 0
    assert got["spans"]["neuralForward"]["calls"] == len(rows)
    names = {n for n, _, _ in ranges}
    assert {"primaryRays", "shellTrace", "neuralForward", "initPathState",
            "sampleBounce", "compactBounce", "earlyTermination",
            "integrateBounce", "finalize", "sync.marchActive",
            "sync.marchCompact", "sync.marchScatter", "sync.bounceCompact",
            "sync.bounceActive"} <= names
    assert not names & {"primaryTrace", "bounceTrace", "frame"}
    for child in ("neuralForward", "sync.marchActive", "sync.marchCompact",
                  "sync.marchScatter", "sync.cameraEntry"):
        assert _nested(ranges, child, "shellTrace"), child
    assert _nested(ranges, "sync.bounceCompact", "compactBounce")
    assert _nested(ranges, "sync.sampleCount", "finalize")
    # Stages do not nest in one another, but for the network in the march.
    stages = [r for r in ranges if r[0] in spans.STAGES
              and r[0] != "neuralForward"]
    for i, (a, sa, ea) in enumerate(stages):
        for b, sb, eb in stages[i + 1:]:
            assert ea <= sb or eb <= sa, (a, b)


def test_gt_frame_spans_and_image(scene):
    frame = _gt(scene)
    img0, accum0 = frame()
    (img1, accum1), ranges, got = _traced(frame)
    assert torch.equal(img0, img1) and torch.equal(accum0, accum1)
    assert (img0 != img0[0, 0]).any()
    names = {n for n, _, _ in ranges}
    assert {"primaryRays", "primaryTrace", "initPathState", "sampleBounce",
            "bounceTrace", "integrateBounce", "finalize",
            "sync.bounceActive", "sync.sampleCount"} <= names
    assert not names & {"shellTrace", "neuralForward", "compactBounce"}
    assert got["counts"] == {}
    assert got["spans"]["bounceTrace"]["calls"] == \
        got["spans"]["sampleBounce"]["calls"]
