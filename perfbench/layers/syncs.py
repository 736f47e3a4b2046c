"""Host syncs a call inside the program's sync spans (`nr.sync.*`,
`utils/spans.py`): the runtime's cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize and blocking cudaMemcpy calls
of the traced window whose start lies inside one. A sync outside every
sync span (the harness's own read of a training step's loss) is not
counted. None where the program marks no sync span."""

import numpy as np

from layers._program import SYNC_CALLS, inside, sync_spans


def read(tr):
    tl = tr.timeline
    ranges = sync_spans(tl)
    if ranges is None:
        return None
    lo, hi = tl.window
    t = np.asarray([s for n, s in zip(tl.host_names, tl.host_s.tolist())
                    if n in SYNC_CALLS and lo <= s <= hi], np.int64)
    return float(inside(t, *ranges).sum()) / tr.calls
