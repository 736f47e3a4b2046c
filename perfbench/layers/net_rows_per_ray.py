"""The live rows the program hands its network a ray: its own `net_rows`
counter (`models/nbvh.py::apply`, the rows of `active`, else all; summed
on the device over the traced window) over the window's rays, a call's
rays times the calls. None where the program keeps no such counter."""

from layers._program import totals


def read(tr):
    t = totals()
    rows = t["counts"].get("net_rows") if t else None
    if not rows:
        return None
    return rows / (tr.sizes["work_per_call"] * tr.calls)
