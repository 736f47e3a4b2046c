"""Training forward and backward of the lane-grid network: CUDA kernels +
PyTorch twin.

Port of `neural_renderer_tpu/ops/lane_grid_train_kernel.py`
(`_make_apply_train`, `_train_tables2d`, and the TPU kernel K6,
`_bwd_kernel`). `apply_train(net, inputs)` is a `torch.autograd.Function`:

  * forward: K2 (`csrc/lane_grid_forward.cu`) in training layout, through
    `lane_grid_kernel.forward_train`: the f32 master tables as [P*L*F*rows,
    128] rows at entry_pack 1, every block live;
  * backward: `backward_lane`, which launches `csrc/lane_grid_backward.cu`
    (K6) on CUDA tensors and runs `backward_twin` on CPU tensors.

Gradients go to the parameters only; the input cotangent is zeros (the
trainer's inputs are sampled data). MLP gradients are taken with respect to
the bf16-cast weights, as the TPU kernel takes them; the optimizer keeps f32
masters.

The kernel's design and bound are described in its source. The twin rounds
where the kernel rounds (see the source's "Rounding points"), so the two
compute one function up to the order of f32 sums.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, lane_grid_kernel
from ..models import lane_grid, nbvh

_H_ROWS = 5 * 128          # scratch rows: activations h0..h4
_D_ROWS = 4 * 128 + 16     # deltas db0..db3, then bf16(g)
_SLICE = 32                # rays per slice of the kernel's reduction


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def table_grad_twin(net: nbvh.ShellNetwork, x, d_enc):
    """Table gradients from d_enc [N, >= P*L*F] f32: every (ray, corner,
    feature) adds bf16(d_enc * corner weight) to its entry, in f32. Returns
    the gradient in the master tables' shape."""
    cfg = net.config
    tables = net.lane
    n_entries = tables[0, 0, 0].numel()
    d_t = torch.zeros((cfg.point_count, cfg.n_levels, cfg.n_features,
                       n_entries), dtype=torch.float32, device=x.device)
    k = 0
    for p in range(cfg.point_count):
        for level in range(cfg.n_levels):
            for idx, wc in lane_grid.level_corners(
                    x[3 * p:3 * p + 3], level, cfg.base_resolution,
                    cfg.per_level_scale, n_entries):
                for f in range(cfg.n_features):
                    d_t[p, level, f].index_add_(
                        0, idx, _bf16(d_enc[:, k + f] * wc))
            k += cfg.n_features
    return d_t.reshape(tables.shape)


def backward_twin(net: nbvh.ShellNetwork, x, g):
    """Plain-PyTorch backward of the training forward. x [12, N] f32, g
    [16, N] f32 (the output cotangent) -> (d_lane in the masters' shape,
    [dW0 [128, encoded], dW1, dW2, dW3 [128, 128], dWout [16, 128]]), all
    f32, summed over the N rays."""
    cfg = net.config
    with torch.no_grad():
        w = [m.to(torch.float32) for m in
             lane_grid_kernel.pack_lane_weights(net)]
        enc = nbvh.encode_inputs(net, x)
        h = _bf16(torch.nn.functional.pad(
            enc, (0, w[0].shape[1] - enc.shape[1])))
        hs, masks = [h], []
        for wl in w[:-1]:
            a = h @ wl.T
            masks.append(a > 0)
            h = _bf16(torch.where(a > 0, a, nbvh.LEAKY_SLOPE * a))
            hs.append(h)
        gb = _bf16(g.T.to(torch.float32))
        dws = [None] * 5
        dws[4] = gb.T @ hs[4]
        delta = gb @ w[4]
        for li in (3, 2, 1, 0):
            delta = torch.where(masks[li], delta, nbvh.LEAKY_SLOPE * delta)
            db = _bf16(delta)
            dws[li] = db.T @ hs[li]
            delta = db @ w[li]
        dws[0] = dws[0][:, :cfg.encoded_dims].contiguous()
        return table_grad_twin(net, x, delta), dws


def backward_lane(net: nbvh.ShellNetwork, x, g):
    """The backward of `apply_train` (K6): x [12, N], g [16, N] ->
    (d_lane, [dW0, dW1, dW2, dW3, dWout]) as `backward_twin` returns them.
    CPU tensors run the twin; CUDA tensors launch
    csrc/lane_grid_backward.cu."""
    if not x.is_cuda:
        return backward_twin(net, x, g)
    cfg = net.config
    lane_grid_kernel.check_kernel_config(cfg, "lane_grid_backward")
    if not net.lane.is_cuda:
        raise ValueError("backward_lane: network weights must be on the GPU")
    ops = lane_grid_kernel._operands(net, train=True)
    x = x.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    n = x.shape[1]
    if g.shape != (16, n) or x.shape[0] != cfg.input_dims:
        raise ValueError(f"backward_lane: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} do not fit")
    dev = x.device
    stride = -(-max(n, 1) // _SLICE) * _SLICE
    hs = torch.empty((_H_ROWS, stride), dtype=torch.bfloat16, device=dev)
    ds = torch.empty((_D_ROWS, stride), dtype=torch.bfloat16, device=dev)
    d_tables = torch.zeros_like(ops.tables2d)
    d_w = torch.zeros((4 * 128 * 128 + 16 * 128,), dtype=torch.float32,
                      device=dev)
    lib = cuda_build.load("lane_grid_backward")
    p = cuda_build.ptr
    rc = lib.lane_grid_backward(
        p(x), p(g), ctypes.c_int(n), ctypes.c_int(stride), p(ops.tables2d),
        p(ops.w_hidden), p(ops.w_out), p(ops.scales),
        ctypes.c_int(cfg.point_count), ctypes.c_int(cfg.n_levels),
        ctypes.c_int(ops.sublanes), ctypes.c_int(cfg.encoded_dims), p(hs),
        p(ds), p(d_tables), p(d_w), cuda_build.stream_of(x))
    cuda_build.check(lib, rc, "lane_grid_backward")
    backward_lane.launches += 1
    sq = 128 * 128
    dws = [d_w[i * sq:(i + 1) * sq].view(128, 128) for i in range(4)]
    dws[0] = dws[0][:, :cfg.encoded_dims]
    dws.append(d_w[4 * sq:].view(16, 128))
    return d_tables.view(net.lane.shape), dws


backward_lane.launches = 0


class _ApplyTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, net, inputs, lane, *mlp):
        ctx.net = net
        ctx.save_for_backward(inputs, lane, *mlp)
        return lane_grid_kernel.forward_train(net, inputs)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors[0]
        d_lane, dws = backward_lane(ctx.net, inputs, g)
        d_inputs = (torch.zeros_like(inputs) if ctx.needs_input_grad[1]
                    else None)
        return (None, d_inputs, d_lane, *dws)


def apply_train(net: nbvh.ShellNetwork, inputs):
    """Training forward [12, N] -> [padded_output_dims, N] f32 whose
    backward gives the parameters' gradients through K6 (see the module
    docstring)."""
    if net.config.grid_type != "lane":
        raise ValueError("apply_train takes lane-grid networks only")
    return _ApplyTrain.apply(net, inputs, net.lane, *net.mlp)
