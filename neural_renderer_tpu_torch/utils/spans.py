"""Named spans and counters inside the port, on the profiler's clock.

`span(name)` marks a stretch of the program as `nr.<name>` and
`count(name, value)` adds to a named total. Both record only while the
torch profiler records (`torch.autograd._profiler_enabled()`); otherwise
`span` hands back one shared no-op context after that single check, and
nothing is allocated or launched. So a window run under the profiler
reads its own numbers from `totals()` afterwards, and a run without it
pays one check a span.

While recording, a span enters `torch.profiler.record_function("nr." +
name)`: the trace then holds it as a host range with a start, an end and
a parent (by nesting), on the clock of the device operations. A stage
span (a name in STAGES) on a process that uses CUDA also records a pair
of timing CUDA events on the current stream, so `totals()` gives each
stage's device seconds: from the device reaching the stage's first event
to reaching its last, any idle inside included. Sync spans, named
`sync.<site>`, wrap each statement that makes the host wait for the
device.

Names (the metrics of perfbench/ that read them in brackets):
  stages   the frame's (CATEGORIES, primaryRays, compactBounce) and the
           training step's (sampleSegments, lossGrad, optimizerStep)
           [march_ms, sample_ms, integrate_ms, segments_ms];
  outer    `frame` (a render or one batch of an accumulation),
           `frameParams` (the host's set-up of a frame, of a batch or of
           an accumulation: its settings, buffers and parameters) and
           `trainStep`, no events;
  sync.*   the host syncs [syncs, sync_idle];
  net_rows the live rows handed to the network (`models/nbvh.py::apply`)
           [net_rows_per_ray].
"""

from __future__ import annotations

import torch

PREFIX = "nr."
SYNC = "sync."

# The reference's 13 KernelId stage categories (render/profiler.py's
# table), in its order.
CATEGORIES = (
    "primaryTrace", "shellTrace", "neuralForward", "initPathState",
    "sampleBounce", "earlyTermination", "bounceTrace",
    "additionalMeshPrimary", "additionalMeshBounce", "selectClosestPrimary",
    "selectClosestBounce", "integrateBounce", "finalize",
)
# Stages the reference does not name: the camera rays, the bounce's
# compaction and the training step's three.
PORT_STAGES = ("primaryRays", "compactBounce", "sampleSegments", "lossGrad",
               "optimizerStep")
STAGES = frozenset(CATEGORIES + PORT_STAGES)

_recording = torch.autograd._profiler_enabled


class _Record:
    """What the spans and counters hold until `totals()` reads it."""

    def __init__(self):
        self.calls = {}          # span name -> calls
        self.device_s = {}       # stage name -> folded device seconds
        self.pairs = []          # (stage name, start, end) not yet read
        self.counts = {}         # counter -> host total
        self.device_counts = {}  # counter -> 0-d int64 tensor on its device

    def fold(self):
        """Turn the event pairs into seconds, each once its end event has
        completed."""
        for name, start, end in self.pairs:
            end.synchronize()
            self.device_s[name] = self.device_s.get(name, 0.0) \
                + start.elapsed_time(end) * 1e-3
        self.pairs.clear()


_RECORD = _Record()


class _Off:
    """The span of a program that is not being traced."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_name", "_range", "_start")

    def __init__(self, name: str):
        self._name = name
        self._range = torch.profiler.record_function(PREFIX + name)
        self._start = None

    def __enter__(self):
        self._range.__enter__()
        if self._name in STAGES and torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    def __exit__(self, *exc):
        rec = _RECORD
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.pairs.append((self._name, self._start, end))
        rec.calls[self._name] = rec.calls.get(self._name, 0) + 1
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that marks its body as `nr.<name>` while the
    profiler records, and does nothing otherwise."""
    if not _recording():
        return _OFF
    return _Span(name)


def count(name: str, value) -> None:
    """Add `value` (a Python int, or a 0-d integer tensor, summed on its
    device with no host sync) to the total `name`, while the profiler
    records."""
    if not _recording():
        return
    rec = _RECORD
    if isinstance(value, torch.Tensor):
        acc = rec.device_counts.get(name)
        if acc is None:
            acc = rec.device_counts[name] = torch.zeros(
                (), dtype=torch.int64, device=value.device)
        acc += value
    else:
        rec.counts[name] = rec.counts.get(name, 0) + int(value)


def totals() -> dict:
    """What was recorded since the last `reset()`: {"spans": {name:
    {"calls", "device_s"}}, "counts": {name: int}}. `device_s` is a
    stage's summed device seconds from its event pairs, None where no pair
    was recorded (other spans, or no CUDA). Waits for the device."""
    rec = _RECORD
    rec.fold()
    for name, acc in rec.device_counts.items():
        rec.counts[name] = rec.counts.get(name, 0) + int(acc)
    rec.device_counts.clear()
    return {"spans": {name: {"calls": calls,
                             "device_s": rec.device_s.get(name)}
                      for name, calls in rec.calls.items()},
            "counts": dict(rec.counts)}


def reset() -> None:
    """Forget everything recorded."""
    global _RECORD
    _RECORD = _Record()
