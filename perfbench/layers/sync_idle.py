"""The share of the traced window, in %, in device-idle gaps that open
while the host is inside one of the program's sync spans (`nr.sync.*`,
`utils/spans.py`): the device drained while the host waited for it, and
stayed idle until the host's next launch. `device_idle` less this share
is the idle the host's dispatch leaves. None where the program marks no
sync span."""

from harness.trace import _gaps
from layers._program import inside, sync_spans


def read(tr):
    tl = tr.timeline
    ranges = sync_spans(tl)
    if ranges is None:
        return None
    gs, ge = _gaps(tl.dev_s, tl.dev_e, *tl.window)
    opened = inside(gs, *ranges)
    return 100.0 * float((ge - gs)[opened].sum()) * 1e-9 / tr.window_s
