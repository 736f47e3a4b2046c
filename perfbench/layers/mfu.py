"""The whole frame's share of the card's bf16 dense peak, in %: the
network is the model, so its work is 2 x 65,536 multiply-adds (the MLP's
weights) for every live row handed to `models/nbvh.py::apply`, over the
traced window's seconds."""


def read(tr):
    rows = tr.counters.get("net_rows") or []
    if not sum(rows):
        return None
    flops = 2.0 * tr.sizes["macs_per_row"] * sum(rows)
    return 100.0 * flops / (tr.window_s * tr.peaks["bf16_flops"])
