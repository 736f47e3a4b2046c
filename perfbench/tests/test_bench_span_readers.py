"""The readers of the program's spans and counters (`syncs`, `sync_idle`,
the stage times, `net_rows_per_ray`) on hand-made timelines and totals,
and what they return where the program has neither."""

import sys

import pytest

from harness import manifest, records
from harness.trace import Timeline

# Device work 0-100, 300-400, 600-1000 ns of a 1000 ns window: gaps at
# 100-300 (opened inside a sync span) and 400-600 (opened outside one).
DEVICE = [("k", 0, 100), ("k", 300, 400), ("k", 600, 1000)]
HOST = [("perfbench.call", 0, 1000), ("nr.frame", 0, 1000),
        ("nr.shellTrace", 50, 700), ("nr.sync.marchActive", 90, 250),
        ("cudaStreamSynchronize", 120, 240),
        ("nr.sync.marchCompact", 240, 260),
        ("cudaStreamSynchronize", 245, 255),
        ("cudaMemcpyAsync", 95, 110), ("aten::add", 420, 430),
        ("cudaStreamSynchronize", 450, 560), ("cudaMemcpy", 900, 950)]


def _traced(host=HOST, calls=2, work=1000):
    return records.Traced(Timeline(list(DEVICE), list(host), (0, 1000)),
                          call_s=[0.5] * calls,
                          sizes={"work_per_call": work})


def _read(name, tr):
    return manifest.reader("layers", name).read(tr)


@pytest.mark.parametrize("part", ["view", "eval", "gt", "train"])
def test_sync_idle_counts_gaps_opened_inside_a_sync_span(part):
    # The 100-300 gap opens at 100, inside nr.sync.marchActive: 200 of
    # the window's 1000 ns. The 400-600 gap opens under nr.shellTrace.
    assert _read(f"sync_idle.{part}", _traced()) == pytest.approx(20.0)


@pytest.mark.parametrize("part", ["view", "eval", "gt", "train"])
def test_syncs_counts_runtime_syncs_inside_sync_spans(part):
    # Two stream syncs lie inside sync spans (the touching spans merge);
    # the one at 450 and the blocking copy at 900 do not; an async copy is
    # no sync. Two calls.
    assert _read(f"syncs.{part}", _traced()) == pytest.approx(1.0)
    inside = HOST + [("nr.sync.image", 880, 990)]
    assert _read(f"syncs.{part}", _traced(inside)) == pytest.approx(1.5)


@pytest.mark.parametrize("name", ["syncs.view", "sync_idle.gt"])
def test_timeline_readers_need_the_programs_sync_spans(name):
    bare = [h for h in HOST if not h[0].startswith("nr.")]
    assert _read(name, _traced(bare)) is None


def _totals(spans_, counts):
    return lambda: {"spans": spans_, "counts": counts}


@pytest.mark.parametrize("name, stage", [
    ("march_ms.view", "shellTrace"), ("march_ms.eval", "shellTrace"),
    ("sample_ms.gt", "sampleBounce"), ("integrate_ms.eval",
                                       "integrateBounce"),
    ("segments_ms.train", "sampleSegments")])
def test_stage_ms_a_call(monkeypatch, name, stage):
    from neural_renderer_tpu_torch.utils import spans
    monkeypatch.setattr(spans, "totals", _totals(
        {stage: {"calls": 8, "device_s": 0.03},
         "frame": {"calls": 2, "device_s": None}}, {}))
    assert _read(name, _traced()) == pytest.approx(15.0)
    # No event pairs (no CUDA), or a stage that never ran: nothing.
    monkeypatch.setattr(spans, "totals", _totals(
        {stage: {"calls": 8, "device_s": None}}, {}))
    assert _read(name, _traced()) is None
    monkeypatch.setattr(spans, "totals", _totals({}, {}))
    assert _read(name, _traced()) is None


def test_net_rows_per_ray(monkeypatch):
    from neural_renderer_tpu_torch.utils import spans
    monkeypatch.setattr(spans, "totals", _totals({}, {"net_rows": 640}))
    assert _read("net_rows_per_ray.view", _traced(calls=2, work=1000)) \
        == pytest.approx(0.32)
    monkeypatch.setattr(spans, "totals", _totals({}, {}))
    assert _read("net_rows_per_ray.eval", _traced()) is None


@pytest.mark.parametrize("name", ["march_ms.view", "sample_ms.eval",
                                  "integrate_ms.gt", "segments_ms.train",
                                  "net_rows_per_ray.view"])
def test_program_readers_without_the_programs_spans(monkeypatch, name):
    # A program without utils/spans.py: the import fails, nothing is read.
    from neural_renderer_tpu_torch import utils
    from neural_renderer_tpu_torch.utils import spans
    monkeypatch.setattr(spans, "totals", _totals(
        {s: {"calls": 1, "device_s": 1.0} for s in spans.STAGES},
        {"net_rows": 640}))
    assert _read(name, _traced()) is not None
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "neural_renderer_tpu_torch.utils.spans",
                        None)
    assert _read(name, _traced()) is None
