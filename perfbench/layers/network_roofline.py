"""K2's share of its roofline, in %: for each call of the lane-grid
network, the least time of its work, the larger of its live rows x 2 x
65,536 flops at the bf16 dense peak and its bytes (each row's 12 f32
inputs read and 16 f32 outputs written once, the bf16 tables and weights
read once) at the HBM peak; summed over the calls, over K2's device
time."""

KERNELS = ("lane_grid_forward_kernel",)


def read(tr):
    rows = tr.counters.get("net_rows") or []
    k2 = tr.kernel_s(KERNELS)
    if not rows or k2 <= 0.0:
        return None
    s, p = tr.sizes, tr.peaks
    bound = sum(max(2.0 * s["macs_per_row"] * r / p["bf16_flops"],
                    (s["row_bytes"] * r + s["fixed_bytes"]) / p["hbm_bytes"])
                for r in rows if r)
    return 100.0 * bound / k2
