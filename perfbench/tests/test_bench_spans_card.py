"""On the card: a traced window of each cell at its own size, its calls
marked as `run.py`'s traced window marks them (after one traced call that
warms the profiler), against the program's spans and counters
(`neural_renderer_tpu_torch/utils/spans.py`):

  * every runtime sync inside a `perfbench.call` lies inside one of the
    program's `nr.sync.*` spans (a training call is the step alone: the
    harness's read of its loss is the harness's sync, not the program's);
  * the program's `net_rows` equals the harness's shim's sum
    (`run.RowCounter`) over the same calls;
  * none of the 10 longest idle gaps is named `nr.frame` or
    `nr.trainStep`, and one named `perfbench.call` is centred in the
    harness's own code at a call's edge, before the call's first `nr.*`
    span or after its last: the program names what the host does. The
    gap between two frames opens at the image's copy and closes at the
    next frame's first launch, so its middle falls on the harness's tens
    of microseconds between its mark and the program's `nr.frame`
    whenever the time before them matches the time after (a 3.1 ms gap
    of `gt_view` on an H100). The window lasts SECONDS, as a short
    benchmark window: over a few calls the ten longest gaps are under a
    millisecond, and such a gap centred on the microseconds between two
    adjacent spans is named by their parent (0.6-0.8 ms gaps between
    `nr.sampleSegments` and `nr.lossGrad`, named `nr.trainStep`).

    python -m pytest perfbench/tests/test_bench_spans_card.py -m cuda -s -q

prints each cell's readings of the new metrics."""

import os
import time

import numpy as np
import pytest
import torch

import run
from harness import cells, manifest, records
from harness import trace as tr
from layers._program import SYNC_CALLS, inside, sync_spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["sphere_lane16.view", "knot_lane16.evaluate", "knot_lane16.gt_view",
         "knot_lane16.train"]
SECONDS = 5.0
UNNAMED = ("nr.frame", "nr.trainStep")


def _label(host, t):
    """The innermost host event around time t, and the innermost nr.*
    span around it."""
    around = [h for h in host if h[1] <= t <= h[2]]
    inner = min(around, key=lambda h: h[2] - h[1], default=("none", 0, 0))
    named = [h for h in around if h[0].startswith("nr.")]
    span = min(named, key=lambda h: h[2] - h[1], default=("none", 0, 0))
    return f"{inner[0]} in {span[0]}"


def _at_call_edge(host, marks, mid):
    """Where time `mid` lies in its call: in us before the call's first
    `nr.*` span or after its last (negative: between them, the program's
    own time)."""
    for a, b in marks:
        if a <= mid <= b:
            inner = [(s, e) for n, s, e in host
                     if n.startswith("nr.") and a <= s and e <= b]
            if not inner:
                return (b - a) * 1e-3
            return max(min(s for s, _ in inner) - mid,
                       mid - max(e for _, e in inner)) * 1e-3
    return float("inf")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_traced_calls_name_syncs_and_count_rows(workload, cuda_device):
    from neural_renderer_tpu_torch.ops import cuda_build
    from neural_renderer_tpu_torch.utils import spans
    cuda_build.build()
    man = manifest.load(ROOT)
    wl = manifest.workload(man, workload)
    traffic = manifest.read_json("traffic", wl["traffic"])
    cfg = manifest.config_path(man, wl["config"], ROOT)
    cell = cells.make(cfg, traffic, 20261018, cuda_device)
    train = traffic["kind"] == "train"
    call = (lambda: cell.step(cell.state, cell.gen)) if train else cell.call
    for _ in range(2):
        call()
    torch.cuda.synchronize()

    spans.reset()
    counter = run.RowCounter()
    rec = tr.Recorder()
    rec.start()
    call()
    spans.reset()
    counter.rows.clear()
    calls = 0
    t0 = time.perf_counter()
    while calls < 2 or time.perf_counter() - t0 < SECONDS:
        # Each output is held until the next call returns, as run.py's
        # window holds it: the view's last 25 MB image is then freed in the
        # harness's code, at the call's edge, and not in the frame's.
        with torch.autograd.profiler.record_function("perfbench.call"):
            out = call()
        calls += 1
    del out
    torch.cuda.synchronize()
    host, dev = rec.stop()
    rows = counter.close()
    got = spans.totals()

    marks = [(s, e) for n, s, e in host if n == "perfbench.call"]
    window = (min(s for s, _ in marks), max(e for _, e in marks))
    tl = tr.Timeline(dev, host, window)
    syncs = [(n, s) for n, s, e in host if n in SYNC_CALLS
             and any(a <= s <= b for a, b in marks)]
    ranges = sync_spans(tl)
    assert ranges is not None
    ok = inside([s for _, s in syncs], *ranges)
    outside = sorted({_label(host, s) for (_, s), k in zip(syncs, ok)
                      if not k})
    gaps = tr.idle_gaps(tl)
    gs, ge = tr._gaps(tl.dev_s, tl.dev_e, *tl.window)
    mids = [(gs[i] + ge[i]) // 2
            for i in np.argsort(gs - ge, kind="stable")[:len(gaps)]]
    edges = [_at_call_edge(host, marks, m)
             for g, m in zip(gaps, mids) if g[0] == "perfbench.call"]

    traced = records.Traced(tl, [0.0] * calls, {"net_rows": rows},
                            dict(cells.network_sizes(cfg),
                                 work_per_call=cell.work_per_call))
    readings = {m["name"]: manifest.reader("layers", m["name"]).read(traced)
                for m in manifest.metrics_of(man, "per_layer", workload)
                if m["source"] in ("program_span", "program_counter")
                or m["name"].startswith("device_idle")}
    print(f"\n{workload}: {calls} calls, {len(syncs) / calls} syncs a call, {readings}, "
          f"net_rows {got['counts'].get('net_rows', 0)} / shim {sum(rows)}, "
          f"gaps {gaps}, outside {outside}, perfbench.call gaps' "
          f"middles at the call's edge (us) {edges}")
    print({k: v for k, v in got["spans"].items()
           if not k.startswith(spans.SYNC)})

    assert not outside, outside
    assert got["counts"].get("net_rows", 0) == sum(rows)
    if not train:
        assert got["spans"]["frame"]["calls"] == calls
    assert not [g for g in gaps if g[0] in UNNAMED], gaps
    assert all(d >= 0 for d in edges), (gaps, edges)
    cell.close()
