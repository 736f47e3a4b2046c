"""Fused lane-grid network forward: CUDA kernel + PyTorch twin.

Port of `neural_renderer_tpu/ops/lane_grid_kernel.py` (TPU kernel K2,
`_forward_kernel`, with `pack_lane_weights` and the table packing of
`forward_lane`): [12, N] -> [16, N], hash encode + SH + 4 bias-free LeakyReLU
layers + output layer, bf16 operands with f32 accumulation, and 128-ray
blocks without an active ray writing zeros.

Tables at entry_pack=2 are packed as on the TPU: two bf16 entries per 32-bit
word, half 0 in the low 16 bits; bit 7 of the hash index selects the half.
The training forward (`forward_train`, from
`neural_renderer_tpu/ops/lane_grid_train_kernel.py::_train_tables2d` and
`_make_apply_train.fwd_only`) runs the same kernel on the f32 master tables
at entry_pack 1, S * pack rows per table, every block live.

Kernel `csrc/lane_grid_forward.cu` replaces `_forward_kernel`. Persistent
blocks of 256 threads (two 128-ray groups, one thread per ray) keep the four
[128, 128] hidden weights and the [16, 128] output weight, bf16, in 132 KB
of dynamic shared memory, loaded once per block. Each thread encodes its ray
(786 KB of packed tables at S=16, read from L2 where they stay resident),
writes its 112 features (zero-padded to 128) as bf16 to its own shared
column, then runs the layers in f32 FMAs over bf16 operands, re-rounding
each hidden activation to bf16. Bound on the card: operations, 2 x 67,584
multiply-adds per ray of the MLP; this first version runs them on the FP32
pipes (the tensor-core `mma`/`wgmma` form is later work), so its bound is
taken against the bf16 tensor-core peak and it is far from it.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from ..models import lane_grid, nbvh

LANES = 128
_OUT_DIMS = 16
_WIDTH = 128


def pack_lane_weights(net: nbvh.ShellNetwork, dtype=torch.bfloat16):
    """MLP [out, in] matrices -> zero-padded [out, width] blocks in `dtype`
    (input dims padded to the MLP width)."""
    width = net.config.mlp_width
    mats = []
    for w in list(net.mlp)[:-1]:
        pad_in = -(-w.shape[1] // width) * width - w.shape[1]
        mats.append(torch.nn.functional.pad(w.to(dtype), (0, pad_in)))
    mats.append(net.mlp[-1].to(dtype))
    return mats


def pack_lane_tables(tables):
    """[P, L, F, S, 2, 128] f32 -> ([P*L*F*S, 128] f32 words holding two
    bf16 entries each, half 0 in the low 16 bits, 2); [P, L, F, S, 128] ->
    (the same rows in f32, 1)."""
    if tables.dim() == 6:
        p_, l_, f_, s_, pk, lanes = tables.shape
        if pk != 2:
            raise ValueError("lane_entry_pack must be 1 or 2")
        u = tables.to(torch.bfloat16).view(torch.int16).to(torch.int64) \
            & 0xFFFF
        packed = (u[..., 1, :] << 16) | u[..., 0, :]
        packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                             packed).to(torch.int32)
        return packed.view(torch.float32).reshape(p_ * l_ * f_ * s_,
                                                  lanes), 2
    p_, l_, f_, s_, lanes = tables.shape
    return tables.reshape(p_ * l_ * f_ * s_, lanes).to(torch.float32), 1


def _block_mask(active, npad: int, device):
    if active is None:
        return torch.ones((npad // LANES,), dtype=torch.int32, device=device)
    a = torch.nn.functional.pad(active, (0, npad - active.shape[0]))
    return a.reshape(npad // LANES, LANES).any(dim=1).to(torch.int32)


def _unpack_words(tables2d, shape):
    """Inverse of pack_lane_tables at entry_pack=2: packed words -> the
    bf16 entries as f32, in the [P, L, F, S, 2, 128] layout `shape`."""
    w = tables2d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    halves = torch.stack([(w & 0xFFFF) << 16, w & 0xFFFF0000], dim=-2)
    halves = torch.where(halves >= 2 ** 31, halves - 2 ** 32, halves)
    return halves.to(torch.int32).view(torch.float32).reshape(shape)


def forward_lane_twin(net: nbvh.ShellNetwork, x_pad, block_mask):
    """Plain-PyTorch twin of the kernel on padded inputs [12, Npad]: the
    table entries the kernel reads (unpacked from the same bf16 words at
    entry_pack=2, f32 at 1), the same encode, and the bf16-operand /
    f32-accumulate MLP; dead blocks output zeros."""
    tables2d, entry_pack = pack_lane_tables(net.lane)
    tables = (_unpack_words(tables2d, net.lane.shape) if entry_pack == 2
              else net.lane)
    encoded = nbvh.encode_inputs(net, x_pad, tables=tables)
    out = nbvh.mlp_forward(list(net.mlp), encoded)
    live = torch.repeat_interleave(block_mask != 0, LANES)
    return torch.where(live[None, :], out, torch.zeros_like(out))


def train_tables2d(tables):
    """Master tables -> ([P*L*F*rows, 128] f32 rows, rows): the training
    layout, rows = S * pack. The pack axis folds into the row index (entry
    = row * 128 + lane, the row-major flatten of the trailing axes), with no
    bf16 packing, so gradients are taken against the f32 masters. A view of
    the masters."""
    lanes = tables.shape[-1]
    rows = tables[0, 0, 0].numel() // lanes
    return tables.reshape(-1, lanes), rows


class _KernelOperands:
    """Packed tables/weights/scales for one network, cached on the module
    and rebuilt when a parameter changes (tensor version counters, which
    the optimizer's in-place steps advance). `train`: the training layout
    (f32 tables at entry_pack 1, `train_tables2d`) instead of the inference
    packing."""

    def __init__(self, net: nbvh.ShellNetwork, train: bool):
        cfg = net.config
        self.key = _params_key(net)
        with torch.no_grad():
            if train:
                self.tables2d, self.sublanes = train_tables2d(net.lane)
                self.entry_pack = 1
            else:
                self.tables2d, self.entry_pack = pack_lane_tables(net.lane)
                self.sublanes = net.lane.shape[3]
            self.tables2d = self.tables2d.detach().contiguous()
            w = pack_lane_weights(net)
            # [in, out] row-major so a thread reads 8 consecutive outputs of
            # one input with a single 16-byte shared-memory load.
            self.w_hidden = torch.stack([m.t() for m in w[:-1]]).contiguous()
            self.w_out = w[-1].t().contiguous()
        self.scales = torch.tensor(
            [lane_grid.level_scale(lv, cfg.base_resolution,
                                   cfg.per_level_scale)
             for lv in range(cfg.n_levels)],
            dtype=torch.float32, device=net.lane.device)


def _params_key(net):
    return tuple((p.data_ptr(), p._version) for p in net.parameters())


def _operands(net: nbvh.ShellNetwork, train: bool = False) -> _KernelOperands:
    attr = "_train_operands" if train else "_kernel_operands"
    ops = getattr(net, attr, None)
    if ops is None or ops.key != _params_key(net):
        ops = _KernelOperands(net, train)
        setattr(net, attr, ops)
    return ops


def check_kernel_config(cfg: nbvh.NbvhConfig, what: str):
    """Raise for a network the lane-grid kernels were not written for."""
    if (cfg.n_features != 4 or cfg.mlp_width != _WIDTH
            or cfg.mlp_hidden_layers != 4 or cfg.input_dims != 12
            or cfg.padded_output_dims != _OUT_DIMS
            or cfg.encoded_dims > _WIDTH or cfg.n_levels > 16):
        raise ValueError(f"{what} kernel does not take {cfg}")


def forward_lane(net: nbvh.ShellNetwork, inputs, active=None):
    """Full network forward through the fused kernel: inputs [12, N] ->
    [padded_output_dims, N] f32. `active` ([N] bool, optional): 128-ray
    blocks with no active ray output zeros. CPU tensors run the twin; CUDA
    tensors launch csrc/lane_grid_forward.cu."""
    n = inputs.shape[1]
    npad = -(-max(n, LANES) // LANES) * LANES
    x = torch.nn.functional.pad(inputs.to(torch.float32), (0, npad - n))
    mask = _block_mask(active, npad, inputs.device)
    if not inputs.is_cuda:
        return forward_lane_twin(net, x, mask)[:, :n]
    return _launch(net, _operands(net), x, mask)[:, :n]


def forward_train(net: nbvh.ShellNetwork, inputs):
    """The training forward (K2 in training layout): inputs [12, N] ->
    [padded_output_dims, N] f32 from the f32 master tables at entry_pack 1
    (S * pack rows per table), every block live. CPU tensors run the twin
    (`nbvh.encode_inputs` + `nbvh.mlp_forward` on the masters); CUDA tensors
    launch csrc/lane_grid_forward.cu. No autograd: see
    ops/lane_grid_train_kernel.py::apply_train."""
    n = inputs.shape[1]
    if not inputs.is_cuda:
        with torch.no_grad():
            return nbvh.mlp_forward(list(net.mlp),
                                    nbvh.encode_inputs(net, inputs))
    npad = -(-max(n, LANES) // LANES) * LANES
    x = torch.nn.functional.pad(inputs.to(torch.float32), (0, npad - n))
    mask = _block_mask(None, npad, inputs.device)
    return _launch(net, _operands(net, train=True), x, mask)[:, :n]


def _launch(net, ops: _KernelOperands, x, mask):
    """One launch of csrc/lane_grid_forward.cu on padded x [12, Npad]."""
    cfg = net.config
    check_kernel_config(cfg, "lane_grid_forward")
    if not net.lane.is_cuda:
        raise ValueError("forward_lane: network weights must be on the GPU")
    x = x.contiguous()
    npad = x.shape[1]
    lib = cuda_build.load("lane_grid_forward")
    out = torch.empty((_OUT_DIMS, npad), dtype=torch.float32,
                      device=x.device)
    p = cuda_build.ptr
    rc = lib.lane_grid_forward(
        p(x), ctypes.c_int(npad), p(mask), p(ops.tables2d),
        p(ops.w_hidden), p(ops.w_out), p(ops.scales),
        ctypes.c_int(cfg.point_count), ctypes.c_int(cfg.n_levels),
        ctypes.c_int(ops.sublanes), ctypes.c_int(ops.entry_pack),
        ctypes.c_int(cfg.encoded_dims), p(out), cuda_build.stream_of(x))
    cuda_build.check(lib, rc, "lane_grid_forward")
    forward_lane.launches += 1
    return out


forward_lane.launches = 0
