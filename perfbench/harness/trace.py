"""The device trace of a window and what the metrics take from it.

The profiler records the host's operator and runtime calls and every
device operation (kernels, copies, fills). Busy time is the union of the
device operations' intervals inside the window, so overlapping kernels
count once; idle time is the rest of the window. The longest idle gaps
are named by what the host was doing then: the innermost host call that
spans the gap's middle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Timeline:
    """Device operations and host calls of one traced window, in ns on one
    clock: device and host are lists of (name, start, end); window is the
    traced window's (start, end)."""
    device: list
    host: list
    window: tuple

    def __post_init__(self):
        lo, hi = self.window
        names, s, e = [], [], []
        for name, ds, de in self.device:
            ds, de = max(ds, lo), min(de, hi)
            if de > ds:
                names.append(name)
                s.append(ds)
                e.append(de)
        self.dev_names = names
        self.dev_s = np.asarray(s, np.int64)
        self.dev_e = np.asarray(e, np.int64)
        self.host_names = [h[0] for h in self.host]
        self.host_s = np.asarray([h[1] for h in self.host], np.int64)
        self.host_e = np.asarray([h[2] for h in self.host], np.int64)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9


def _gaps(starts, ends, lo, hi):
    """Stretches of [lo, hi) that no [start, end) interval covers, as
    (gap starts, gap ends) arrays."""
    if len(starts) == 0:
        return np.asarray([lo]), np.asarray([hi])
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    prev = np.concatenate([[lo], np.maximum(reach[:-1], lo)])
    gs = np.concatenate([prev, [max(reach[-1], lo)]])
    ge = np.concatenate([s, [hi]])
    keep = ge > gs
    return gs[keep], ge[keep]


def union_ns(starts, ends, lo, hi) -> int:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    gs, ge = _gaps(np.clip(np.asarray(starts, np.int64), lo, hi),
                   np.clip(np.asarray(ends, np.int64), lo, hi), lo, hi)
    return int(hi - lo - (ge - gs).sum())


def busy_s(tl: Timeline) -> float:
    return union_ns(tl.dev_s, tl.dev_e, *tl.window) * 1e-9


def idle_gaps(tl: Timeline, top: int = 10):
    """The `top` longest stretches of the window with no device operation,
    as [(label, seconds)]: the label names the innermost host call spanning
    the gap's middle ("host: none" where no recorded call does)."""
    gs, ge = _gaps(tl.dev_s, tl.dev_e, *tl.window)
    out = []
    for i in np.argsort(gs - ge, kind="stable")[:top]:
        mid = (gs[i] + ge[i]) // 2
        inside = np.nonzero((tl.host_s <= mid) & (tl.host_e >= mid))[0]
        if inside.size:
            j = inside[np.argmin(tl.host_e[inside] - tl.host_s[inside])]
            label = tl.host_names[j]
        else:
            label = "host: none"
        out.append([label, float(ge[i] - gs[i]) * 1e-9])
    return out


def device_ops(tl: Timeline, top: int = 10):
    """The `top` device operations by summed time, [(name, seconds)]."""
    sums = {}
    for name, d in zip(tl.dev_names, (tl.dev_e - tl.dev_s).tolist()):
        sums[name] = sums.get(name, 0) + d
    ranked = sorted(sums.items(), key=lambda kv: -kv[1])
    return [[name, ns * 1e-9] for name, ns in ranked[:top]]


def seconds_by_name(tl: Timeline) -> dict:
    """Summed device seconds of each operation name."""
    sums = {}
    for name, d in zip(tl.dev_names, (tl.dev_e - tl.dev_s).tolist()):
        sums[name] = sums.get(name, 0) + d
    return {k: v * 1e-9 for k, v in sums.items()}


class Recorder:
    """Records host calls and device operations between start() and
    stop(); stop() returns (host, device) lists of (name, start_ns,
    end_ns). Uses the profiler's raw event list, which avoids building
    the Python event tree (minutes for a million events)."""

    def __init__(self):
        self._prof = None

    def start(self):
        import torch
        from torch._C._profiler import ProfilerActivity
        acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        try:
            from torch._C._profiler import _ExperimentalConfig
            from torch.autograd import ProfilerConfig, ProfilerState
            from torch.autograd import profiler as ap
            cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                 False, False, _ExperimentalConfig())
            ap._prepare_profiler(cfg, acts)
            ap._enable_profiler(cfg, acts)
            self._raw = ap
        except (ImportError, TypeError, AttributeError):
            self._raw = None
            self._prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()

    def stop(self):
        if self._raw is not None:
            events = self._raw._disable_profiler().events()
        else:
            self._prof.__exit__(None, None, None)
            events = self._prof.profiler.kineto_results.events()
        host, device = [], []
        for ev in events:
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.is_user_annotation():
                # Ranges the harness marks (and their device-side
                # copies) are no device work.
                if not str(ev.device_type()).endswith("CUDA"):
                    host.append((ev.name(), s, e))
            elif str(ev.device_type()).endswith("CUDA"):
                device.append((ev.name(), s, e))
            else:
                host.append((ev.name(), s, e))
        return host, device


# Device operations that are PyTorch's, its libraries' or copies: every
# other name is a kernel of the program (its csrc/ libraries).
LIBRARY_PATTERNS = ("at::", "at_cuda_detail", "cub::", "Memcpy", "Memset",
                    "(anonymous namespace)", "cublas", "cutlass", "gemm",
                    "gemv", "nvjet", "splitK", "elementwise_kernel",
                    "reduce_kernel", "CUDA mem", "triton")


def is_library(name: str) -> bool:
    return any(p in name for p in LIBRARY_PATTERNS)
