"""The tcnn-layout fused MLP's host side (ops/fused_network.py), on the CPU.

K7 (csrc/fused_mlp.cu) runs only on the card; what surrounds it is plain
PyTorch and is checked here: the weight image the kernel's wgmma
descriptors read (its layout, its inverse, its zero padding), the bound
`bounds.mlp_seconds` that chip_smoke.py reports beside the kernel's time,
and the wrapper's contract (encode_inputs' [N, 112] f32 rows on the
network's device, the reference architecture only). Exact throughout:
the image is a permutation of bf16 values, the bound is arithmetic.
"""

import numpy as np
import pytest
import torch

from neural_renderer_tpu_torch.models import nbvh
from neural_renderer_tpu_torch.ops import bounds, fused_network as fm

# One intra-op thread: the suite runs several pytest workers side by side.
torch.set_num_threads(1)

TCNN = nbvh.NbvhConfig(grid_type="tcnn")


@pytest.fixture(scope="module")
def net():
    return nbvh.init_params(TCNN, torch.Generator().manual_seed(0), "cpu")


def _image_offset(layer, row, col):
    """Where the kernel reads weight [row, col] of `layer` (the image's
    logical column col; layer 0's columns in `_layer0_order`): K-major
    64-column halves of rows of 128 bytes, 16-byte chunk c of row n at
    chunk c ^ (n % 8), matrices one after another."""
    rows = fm.OUT_DIMS if layer == fm.HIDDEN else fm.WIDTH
    half, chunk, e = col // 64, (col % 64) // 8, col % 8
    return (layer * fm.WIDTH * fm.WIDTH + half * rows * 64 + row * 64
            + (chunk ^ (row % 8)) * 8 + e)


def test_weight_image_layout_and_inverse(net):
    """pack_weights is a permutation of the padded bf16 matrices into the
    135,168-byte image at the offsets the kernel's descriptors assume;
    image_inverse gives back every bf16 [out, in] matrix, and layer 0's 16
    padding columns hold zeros."""
    image = fm.pack_weights(net)
    assert image.dtype == torch.bfloat16
    assert image.numel() * 2 == fm.IMAGE_BYTES == 135168
    back = fm.image_inverse(image)
    assert not back[0][:, fm.IN_DIMS:].any()
    back[0] = back[0][:, :fm.IN_DIMS]
    assert [tuple(m.shape) for m in back] == [tuple(w.shape)
                                              for w in net.mlp]
    for got, w in zip(back, net.mlp):
        assert torch.equal(got, w.to(torch.bfloat16))
    # The layout moves every slot: labels in, each label out exactly once.
    rows = fm.HIDDEN * fm.WIDTH + fm.OUT_DIMS
    src = torch.arange(rows * fm.WIDTH).reshape(rows, fm.WIDTH)
    mats = list(src[:fm.HIDDEN * fm.WIDTH].split(fm.WIDTH)) + \
        [src[fm.HIDDEN * fm.WIDTH:]]
    labels = fm.image_layout(mats)
    assert torch.equal(labels.sort().values, torch.arange(rows * fm.WIDTH))
    for a, b in zip(fm.image_inverse(labels), mats):
        assert torch.equal(a, b)
    # Layer 0: feature 16 s + 4 b + 2 a + j sits at the step's column
    # 8 a + 2 b + j, the A fragment's column of thread b's 16-byte load.
    r = np.random.default_rng(0)
    for _ in range(3000):
        layer = int(r.integers(fm.HIDDEN + 1))
        row = int(r.integers(fm.OUT_DIMS if layer == fm.HIDDEN
                             else fm.WIDTH))
        col = int(r.integers(fm.WIDTH))
        feat = col
        if layer == 0:
            s, q = divmod(col, 16)
            feat = 16 * s + 4 * ((q % 8) // 2) + 2 * (q // 8) + q % 2
        assert int(labels[_image_offset(layer, row, col)]) == \
            int(mats[layer][row, feat])


def test_weight_image_cache():
    """weight_image packs once per network and again only when a matrix is
    replaced or changed in place (an optimizer step bumps its version)."""
    net = nbvh.init_params(TCNN, torch.Generator().manual_seed(2), "cpu")
    image = fm.weight_image(net)
    assert torch.equal(image, fm.pack_weights(net))
    assert fm.weight_image(net) is image
    with torch.no_grad():
        net.mlp[2].mul_(2.0)
    again = fm.weight_image(net)
    assert again is not image and torch.equal(again, fm.pack_weights(net))
    net.mlp[4] = torch.nn.Parameter(net.mlp[4].detach().clone() + 1.0)
    third = fm.weight_image(net)
    assert third is not again and torch.equal(third, fm.pack_weights(net))
    assert fm.weight_image(net) is third


def test_mlp_bound_counts():
    """bounds.mlp_seconds counts 2 x 65,536 operations and 448 + 64 bytes
    a row: at 131,072 rows the bytes decide it (0.0200 ms against 0.0174),
    at 2^21 rows too (0.3205 against 0.2779)."""
    assert TCNN.mlp_n_params == 65536
    for rows, ops_ms, bytes_ms in ((131072, 0.017371, 0.020032),
                                   (1 << 21, 0.277935, 0.320520)):
        got = bounds.mlp_seconds(rows, TCNN.mlp_n_params, 448, 64) * 1e3
        assert got == pytest.approx(bytes_ms, rel=1e-4)
        assert 2 * 65536 * rows / bounds.BF16_TENSOR * 1e3 == \
            pytest.approx(ops_ms, rel=1e-4)
        assert rows * 512 / bounds.BYTES_RATE * 1e3 == \
            pytest.approx(bytes_ms, rel=1e-4)
    # Operations decide it once a row moves fewer bytes than 2 x macs /
    # (989e12 / 3.35e12), about 444.
    assert bounds.mlp_seconds(1000, 65536, 0, 0) == \
        2 * 65536 * 1000 / bounds.BF16_TENSOR


def test_wrapper_contract(net):
    """fused_mlp takes encode_inputs' rows as they are: it runs the twin on
    them, and raises on the old contract's [N, 128] bf16 rows, on a wrong
    width, dtype, rank or device and on a network that is not
    112 -> 4 x 128 -> 16."""
    x = torch.rand((12, 200), generator=torch.Generator().manual_seed(1))
    enc = nbvh.encode_inputs(net, x)
    assert enc.shape == (200, fm.IN_DIMS) and enc.dtype == torch.float32
    out = fm.fused_mlp(net, enc)
    assert out.shape == (fm.OUT_DIMS, 200)
    assert torch.equal(out, nbvh.mlp_forward(list(net.mlp), enc))
    old = torch.nn.functional.pad(enc, (0, 16)).to(torch.bfloat16)
    for bad in (old, enc[:, :100].contiguous(), enc.double(),
                enc.to(torch.bfloat16), enc[None], enc.t()):
        with pytest.raises(ValueError, match="fused_mlp takes"):
            fm.fused_mlp(net, bad)
    meta = torch.empty(enc.shape, device="meta")
    with pytest.raises(ValueError, match="network weights on cpu"):
        fm.fused_mlp(net, meta)
    for cfg in (nbvh.NbvhConfig(grid_type="tcnn", n_levels=2),
                nbvh.NbvhConfig(grid_type="tcnn", mlp_width=64),
                nbvh.NbvhConfig(grid_type="tcnn", mlp_hidden_layers=3)):
        small = nbvh.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        rows = torch.zeros((4, cfg.encoded_dims))
        with pytest.raises(ValueError, match="does not take"):
            fm.fused_mlp(small, rows)


def test_k7_hold_rejects_planted_faults(net):
    """chip_smoke.py's hold of K7 against its twin (k7_errors, k7_faults)
    passes the same MLP summed in float64 (another summation order, as
    the tensor cores take) and rejects both faults k7_planted plants (a
    warp's rows from another tile, neighbouring rows swapped), an error in
    a channel that is all zeros, and one beyond 2e-2 of the largest output
    that is small beside its own channel's."""
    import chip_smoke
    x = torch.rand((12, 1024), generator=torch.Generator().manual_seed(4))
    enc = nbvh.encode_inputs(net, x)
    twin = fm.apply_fused_twin(net, enc)
    other = chip_smoke.k7_summed(net, enc)
    assert not torch.equal(other, twin)
    e = chip_smoke.k7_errors(other, twin)
    assert chip_smoke.k7_faults(e) == "", e
    assert e["rel"] < 1e-2 and e["share"] < 1e-2
    for label, bad in chip_smoke.k7_planted(other, 4).items():
        assert chip_smoke.k7_faults(chip_smoke.k7_errors(bad, twin)), label
    zero = torch.zeros_like(twin)
    assert chip_smoke.k7_faults(chip_smoke.k7_errors(zero, zero)) == ""
    zero[3, 7] = 1e-30
    assert "channel 3" in chip_smoke.k7_faults(
        chip_smoke.k7_errors(zero, torch.zeros_like(twin)))
    big = torch.zeros_like(twin)
    big[0, 0], big[1, 0] = 100.0, 50.0
    off = big.clone()
    off[1, 0] += 3.0
    assert chip_smoke.k7_faults(chip_smoke.k7_errors(off, big)) == \
        "off by 0.03 of the largest output"
