"""What the layer readers take from the program's own spans and counters
(`neural_renderer_tpu_torch/utils/spans.py`). Not a metric: the readers
of `syncs`, `sync_idle`, the stage times and `net_rows_per_ray` share it.
Each returns None where the program has no such module or recorded
nothing, as a program older than its spans does."""

import numpy as np

# The host ranges of the program's sync spans, and the runtime calls that
# make the host wait for the device.
SYNC_SPAN = "nr.sync."
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


def totals():
    """The program's `spans.totals()` after the traced window, or None."""
    try:
        from neural_renderer_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.totals()


def stage_ms(tr, stage: str):
    """Device ms a call in the stage span `nr.<stage>`, from its CUDA
    event pairs: from the device reaching the stage's first event to
    reaching its last, so idle inside the stage counts."""
    t = totals()
    got = t["spans"].get(stage) if t else None
    if not got or not got["device_s"]:
        return None
    return got["device_s"] * 1e3 / tr.calls


def sync_spans(tl):
    """The union of the `nr.sync.*` host ranges that meet the window, as
    sorted disjoint (starts, ends) arrays in ns; None where there is
    none."""
    lo, hi = tl.window
    ranges = sorted((s, e) for n, s, e in zip(tl.host_names,
                                               tl.host_s.tolist(),
                                               tl.host_e.tolist())
                    if n.startswith(SYNC_SPAN) and e >= lo and s <= hi)
    if not ranges:
        return None
    merged = [list(ranges[0])]
    for s, e in ranges[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    a = np.asarray(merged, np.int64)
    return a[:, 0], a[:, 1]


def inside(t, starts, ends):
    """Which of the times `t` lie inside one of the disjoint sorted
    intervals [starts, ends]."""
    t = np.asarray(t, np.int64)
    i = np.searchsorted(starts, t, side="right") - 1
    return (i >= 0) & (t <= ends[np.maximum(i, 0)])
