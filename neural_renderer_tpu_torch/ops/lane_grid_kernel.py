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
at entry_pack 1, S * pack rows per table, every block live. The kernels
read either with the 4 features of one entry adjacent (`kernel_tables`).

Kernel `csrc/lane_grid_forward.cu` replaces `_forward_kernel`. Persistent
blocks of 8 warps keep the four hidden weights and the output weight, bf16,
[in][out] with padded rows, in shared memory. Each warp takes 32 rays: each
lane encodes one ray from the feature-interleaved tables
(`interleave_features`: the 4 features of one entry in 16 bytes, so one
load fetches a corner; 786 KB at S=16, resident in L2) into the warp's
channel-major staging tile, and the MLP runs on the tensor cores
(`mma.sync.m16n8k16`, bf16 x bf16 -> f32) with the activations kept in
registers, as K7 (`csrc/fused_mlp.cu`) does. Bound on the card: operations,
65,536 multiply-adds per ray of the MLP (layer 0 at its 112 real inputs) at
the bf16 tensor-core peak.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from ..models import lane_grid, nbvh
from ..utils import spans

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


def interleave_features(rows2d, lane_shape):
    """Table rows [P*L*F*R, 128] (pack_lane_tables' words, or
    train_tables2d's f32 rows) -> [P*L, R*128, F], contiguous: the F
    features of one word entry adjacent (16 bytes at F=4), so the kernels
    fetch a corner with one load. lane_shape: the masters' shape [P, L, F,
    ...]."""
    p_, l_, f_ = lane_shape[:3]
    return rows2d.reshape(p_ * l_, f_, -1).transpose(1, 2).contiguous()


def deinterleave_features(t):
    """Inverse of interleave_features: [P*L, R*128, F] -> [P*L*F*R, 128]
    rows. Also takes the table gradient K6 adds into that layout back to
    the training rows (a flatten of the masters' shape)."""
    return t.transpose(1, 2).reshape(-1, LANES)


def kernel_tables(net: nbvh.ShellNetwork, train: bool = False):
    """(The tables as the kernel reads them, feature-interleaved, entry
    pack, rows per table): the inference packing (bf16 words at
    entry_pack=2, f32 at 1, S rows) or, with `train`, the f32 masters at
    entry_pack 1 with S * pack rows."""
    with torch.no_grad():
        if train:
            rows2d, rows = train_tables2d(net.lane)
            entry_pack = 1
        else:
            rows2d, entry_pack = pack_lane_tables(net.lane)
            rows = net.lane.shape[3]
        return (interleave_features(rows2d.detach(), net.lane.shape),
                entry_pack, rows)


def forward_lane_twin(net: nbvh.ShellNetwork, x_pad, block_mask):
    """Plain-PyTorch twin of the kernel on padded inputs [12, Npad]: the
    table entries the kernel reads (`kernel_tables`, unpacked from the same
    bf16 words at entry_pack=2, f32 at 1), the same encode, and the
    bf16-operand / f32-accumulate MLP; dead blocks output zeros."""
    tables4, entry_pack, _ = kernel_tables(net)
    rows2d = deinterleave_features(tables4)
    tables = (_unpack_words(rows2d, net.lane.shape) if entry_pack == 2
              else rows2d.reshape(net.lane.shape))
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
    the optimizer's in-place steps advance, so training repacks once per
    step). `train`: the training layout (f32 masters at entry_pack 1)
    instead of the inference packing; both feature-interleaved
    (`kernel_tables`)."""

    def __init__(self, net: nbvh.ShellNetwork, train: bool):
        cfg = net.config
        self.key = _params_key(net)
        self.tables, self.entry_pack, self.sublanes = kernel_tables(net,
                                                                   train)
        with torch.no_grad():
            w = pack_lane_weights(net)
            # [in, out] row-major: the kernels read B fragments of the
            # forward with ldmatrix.trans and of the backward with ldmatrix
            # from this one copy.
            self.w_hidden = torch.stack([m.t() for m in w[:-1]]).contiguous()
            self.w_out = w[-1].t().contiguous()
        with spans.span("sync.laneOperands"):
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
        p(x), ctypes.c_int(npad), p(mask), p(ops.tables),
        p(ops.w_hidden), p(ops.w_out), p(ops.scales),
        ctypes.c_int(cfg.point_count), ctypes.c_int(cfg.n_levels),
        ctypes.c_int(ops.sublanes), ctypes.c_int(ops.entry_pack),
        ctypes.c_int(cfg.encoded_dims), p(out), cuda_build.stream_of(x))
    cuda_build.check(lib, rc, "lane_grid_forward")
    forward_lane.launches += 1
    return out


forward_lane.launches = 0
