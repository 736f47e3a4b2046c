"""What a run hands to the metric readers."""

from __future__ import annotations

from dataclasses import dataclass, field

from .trace import Timeline, busy_s, is_library


@dataclass
class Run:
    """The measured window of a run (tracing off): each call's host-clock
    seconds, the window from the first call's start to the last call's
    end, the work of one call (rays of a frame or batch, segments of a
    training step) and the set-up time."""
    call_s: list
    window_s: float
    work_per_call: int
    setup_s: float

    @property
    def calls(self) -> int:
        return len(self.call_s)


@dataclass
class Traced:
    """The traced window of a run: its device timeline, each call's
    host-clock seconds, the counts the harness kept at layer boundaries
    (`counters`: name -> list of per-call values), the sizes and peaks the
    readers need, and each call's host-clock seconds of the untraced
    window that ran first (`untraced_call_s`; empty unless a reader asked
    for it)."""
    timeline: Timeline
    call_s: list
    counters: dict = field(default_factory=dict)
    sizes: dict = field(default_factory=dict)
    peaks: dict = field(default_factory=dict)
    untraced_call_s: list = field(default_factory=list)

    @property
    def calls(self) -> int:
        return len(self.call_s)

    @property
    def window_s(self) -> float:
        return self.timeline.window_s

    @property
    def busy_s(self) -> float:
        return busy_s(self.timeline)

    def kernel_s(self, patterns) -> float:
        """Summed device seconds of the operations whose name holds any of
        the patterns."""
        tl = self.timeline
        return sum(int(e - s) for name, s, e in zip(tl.dev_names, tl.dev_s,
                                                    tl.dev_e)
                   if any(p in name for p in patterns)) * 1e-9

    def library_s(self) -> float:
        """Summed device seconds of PyTorch's kernels, its libraries' and
        copies."""
        tl = self.timeline
        return sum(int(e - s) for name, s, e in zip(tl.dev_names, tl.dev_s,
                                                    tl.dev_e)
                   if is_library(name)) * 1e-9
