"""The idle union, the breakdown and the mfu / roofline arithmetic on
hand-made timelines."""

import pytest

from harness import manifest, peaks, records
from harness.trace import (Timeline, busy_s, device_ops, idle_gaps,
                           is_library, union_ns)

SIZES = {"macs_per_row": 65536, "row_bytes": 112, "fixed_bytes": 917504}


def _tl(device, host=(), window=(0, 1000)):
    return Timeline(list(device), list(host), window)


def test_union_counts_overlap_once():
    assert union_ns([0, 5, 20], [10, 15, 30], 0, 100) == 25
    assert union_ns([0, 2], [10, 4], 0, 100) == 10
    assert union_ns([], [], 0, 100) == 0
    # Clipped to the window.
    assert union_ns([-50, 90], [10, 200], 0, 100) == 20


def test_busy_and_idle_of_a_timeline():
    tl = _tl([("k1", 100, 300), ("k2", 200, 400), ("k3", 700, 800),
              ("k0", -100, 50)],
             host=[("python", 0, 1000), ("aten::nonzero", 450, 650),
                   ("cudaStreamSynchronize", 500, 600)])
    assert busy_s(tl) == pytest.approx(450e-9)
    gaps = idle_gaps(tl)
    # The longest gap, 400-700, is named by the innermost host call at
    # its middle (550).
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(300e-9)]
    assert [g[1] for g in gaps] == pytest.approx([300e-9, 200e-9, 50e-9])
    assert device_ops(tl)[0] == ["k1", pytest.approx(200e-9)]


def test_library_kernels_are_told_from_the_ports():
    assert is_library("void at::native::vectorized_elementwise_kernel<4>")
    assert is_library("Memcpy DtoH (Device -> Pageable)")
    assert not is_library("lane_grid_forward_kernel")
    assert not is_library("void nr_sweep_cluster_items<true>(float const*)")


def _traced(device, rows, window=(0, 10**9)):
    return records.Traced(_tl(device, window=window), call_s=[0.4, 0.6],
                          counters={"net_rows": rows}, sizes=SIZES,
                          peaks=peaks.H100_SXM)


def test_mfu_of_a_hand_made_window():
    tr = _traced([], [1_000_000, 500_000])
    got = manifest.reader("layers", "mfu.view").read(tr)
    want = 100.0 * 2 * 65536 * 1.5e6 / (1.0 * 989e12)
    assert got == pytest.approx(want)
    assert manifest.reader("layers", "mfu.view").read(
        _traced([], [])) is None


def test_network_roofline_of_a_hand_made_window():
    k2 = [("lane_grid_forward_kernel", 0, 2_000_000),
          ("lane_grid_forward_kernel", 3_000_000, 4_000_000),
          ("void at::native::x", 0, 5_000_000)]
    tr = _traced(k2, [1_000_000, 0, 10])
    flops_s = 2 * 65536 * 1e6 / 989e12
    bytes_s = (112 * 1e6 + 917504) / 3.35e12
    small = max(2 * 65536 * 10 / 989e12, (1120 + 917504) / 3.35e12)
    want = 100.0 * (max(flops_s, bytes_s) + small) / 3e-3
    got = manifest.reader("layers", "network_roofline.view").read(tr)
    assert got == pytest.approx(want)


def test_layer_times_a_call():
    tr = _traced([("nr_trace_cluster_items", 0, 4_000_000),
                  ("void at::native::k", 0, 1_000_000),
                  ("Memcpy DtoH", 0, 1_000_000)], [])
    assert manifest.reader("layers", "trace_ms.gt").read(tr) == \
        pytest.approx(2.0)
    assert manifest.reader("layers", "torch_ops_ms.gt").read(tr) == \
        pytest.approx(1.0)
    assert manifest.reader("layers", "device_idle.gt").read(tr) == \
        pytest.approx(99.6)


def test_frame_tail_of_the_untraced_calls():
    calls = [0.01 * (i + 1) for i in range(100)]
    frame_tail = manifest.reader("layers", "frame_ms_p95.view")
    assert frame_tail.UNTRACED
    tr = records.Traced(_tl([]), call_s=[9.0] * 100, untraced_call_s=calls)
    assert frame_tail.read(tr) == pytest.approx(950.5)
    # The traced calls alone, which the profiler lengthens, give nothing.
    assert frame_tail.read(records.Traced(_tl([]), call_s=calls)) is None
