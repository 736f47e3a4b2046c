"""The whole training step's share of the card's bf16 dense peak, in %:
6 x 65,536 flops (the MLP's multiply-adds, forward and backward) for
every segment trained in the traced window, over its seconds."""


def read(tr):
    flops = 6.0 * tr.sizes["macs_per_row"] * tr.sizes["work_per_call"] \
        * tr.calls
    return 100.0 * flops / (tr.window_s * tr.peaks["bf16_flops"])
