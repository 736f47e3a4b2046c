"""The feature-interleaved table layout of the lane-grid kernels (K2, K6).

The kernels read the tables, and K6 adds the table gradient, with the 4
features of one entry adjacent (`lane_grid_kernel.interleave_features`);
the twins read and scatter through the same layout. These tests hold that
layout to the plain row layout the twins used before it, bit for bit: the
round trip, the forward twin, and the table-gradient scatter. No JAX: the
twins are held to the JAX package by tests/test_torch_lane_grid_kernel.py
and tests/test_torch_train.py.
"""

import numpy as np
import pytest
import torch

from neural_renderer_tpu_torch.models import lane_grid, nbvh
from neural_renderer_tpu_torch.ops import (lane_grid_kernel,
                                           lane_grid_train_kernel)

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

N = 300
CASES = [(s, pack) for s in (4, 16) for pack in (1, 2)]


def _net(sublanes, entry_pack):
    cfg = nbvh.NbvhConfig(lane_sublanes=sublanes,
                          lane_entry_pack=entry_pack)
    net = nbvh.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        net.lane.mul_(1e3)
    r = np.random.default_rng(1)
    x = torch.as_tensor(r.uniform(size=(12, N)).astype(np.float32))
    return net, x


def _rows(net, train):
    """The tables as plain rows [P*L*F*R, 128], before interleaving."""
    if train:
        return lane_grid_kernel.train_tables2d(net.lane)[0]
    return lane_grid_kernel.pack_lane_tables(net.lane)[0]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("sublanes,entry_pack", CASES)
def test_interleave_round_trip(sublanes, entry_pack, train):
    """Entry e of feature f of group g sits at [g, e, f]; de-interleaving
    gives the rows back bit for bit."""
    net, _ = _net(sublanes, entry_pack)
    rows = _rows(net, train).detach()
    t4, pack, r = lane_grid_kernel.kernel_tables(net, train)
    assert pack == (1 if train else entry_pack)
    assert r == sublanes * (entry_pack if train else 1)
    p_, l_, f_ = net.lane.shape[:3]
    assert t4.shape == (p_ * l_, r * 128, f_) and t4.is_contiguous()
    g, e = 5, r * 128 - 3
    want = torch.stack([rows[(g * f_ + f) * r + e // 128, e % 128]
                        for f in range(f_)])
    assert torch.equal(t4[g, e].view(torch.int32), want.view(torch.int32))
    back = lane_grid_kernel.deinterleave_features(t4)
    assert torch.equal(back.view(torch.int32), rows.view(torch.int32))


def _twin_from_rows(net, x_pad, block_mask):
    """The forward twin as it read the tables before interleaving."""
    rows, entry_pack = lane_grid_kernel.pack_lane_tables(net.lane)
    tables = (lane_grid_kernel._unpack_words(rows, net.lane.shape)
              if entry_pack == 2 else net.lane)
    out = nbvh.mlp_forward(list(net.mlp),
                           nbvh.encode_inputs(net, x_pad, tables=tables))
    live = torch.repeat_interleave(block_mask != 0, 128)
    return torch.where(live[None, :], out, torch.zeros_like(out))


@pytest.mark.parametrize("sublanes,entry_pack", CASES)
def test_forward_twin_through_interleave_is_unchanged(sublanes, entry_pack):
    net, x = _net(sublanes, entry_pack)
    x_pad = torch.nn.functional.pad(x, (0, 384 - N))
    active = torch.zeros(N, dtype=torch.bool)
    active[:100] = torch.as_tensor(np.random.default_rng(2)
                                   .uniform(size=100) < 0.3)
    active[256:] = True
    mask = lane_grid_kernel._block_mask(active, 384, "cpu")
    with torch.no_grad():
        got = lane_grid_kernel.forward_lane_twin(net, x_pad, mask)
        want = _twin_from_rows(net, x_pad, mask)
    assert (got[:, 128:256] == 0).all()
    assert torch.equal(got, want)


def _table_grad_rows(net, x, d_enc):
    """The table-gradient scatter into the plain row layout, feature by
    feature, as the twin added it before interleaving."""
    cfg = net.config
    n_entries = net.lane[0, 0, 0].numel()
    d_t = torch.zeros((cfg.point_count, cfg.n_levels, cfg.n_features,
                       n_entries), dtype=torch.float32)
    k = 0
    for p in range(cfg.point_count):
        for level in range(cfg.n_levels):
            for idx, wc in lane_grid.level_corners(
                    x[3 * p:3 * p + 3], level, cfg.base_resolution,
                    cfg.per_level_scale, n_entries):
                for f in range(cfg.n_features):
                    d_t[p, level, f].index_add_(
                        0, idx, (d_enc[:, k + f] * wc).to(torch.bfloat16)
                        .to(torch.float32))
            k += cfg.n_features
    return d_t.reshape(net.lane.shape)


@pytest.mark.parametrize("sublanes,entry_pack", CASES)
def test_table_grad_scatter_through_interleave_is_exact(sublanes,
                                                        entry_pack):
    """The interleaved scatter, de-interleaved, equals the row-layout
    scatter exactly: each entry's f32 sum takes its terms in the same
    order (corner by corner, ray by ray)."""
    net, x = _net(sublanes, entry_pack)
    d_enc = torch.as_tensor(np.random.default_rng(3).normal(
        size=(N, net.config.encoded_dims)).astype(np.float32))
    got = lane_grid_train_kernel.table_grad_twin(net, x, d_enc)
    want = _table_grad_rows(net, x, d_enc)
    assert got.shape == net.lane.shape
    assert (want != 0).sum() > 1000
    assert torch.equal(got, want)
