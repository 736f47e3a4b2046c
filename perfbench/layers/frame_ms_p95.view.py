"""The 95th percentile of the viewer's frame times, in ms, over an
untraced window of the run's length: each frame timed by the host clock
around `Renderer.render`, which returns the host image and so ends
synchronised. The frame is host-paced, so the profiler's host cost would
lengthen exactly this tail; the window it is read from runs before the
traced one, untraced. Its tail swings with the host, so it stands here,
unbounded, beside the cell's rays per second."""

import numpy as np

UNTRACED = True


def read(tr):
    if not tr.untraced_call_s:
        return None
    return float(np.percentile(np.asarray(tr.untraced_call_s) * 1e3, 95))
