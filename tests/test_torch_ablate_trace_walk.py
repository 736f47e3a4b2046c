"""The trace-kernel ablation's closest hit on K3's walk, on the CPU.

csrc/ablate_trace.cu runs `local`, `recip`, `recipx`, `nodiv` and `bf16`
and the block and tile rows on K3's prefiltered walk (csrc/mt_dense.cuh),
each tile math behind its rule (csrc/mt_variants.cuh,
`trace_ablation.variant_rule`). Held here: the prefiltered twin
(`trace_variant_twin(..., prefilter=True)`, the kernel's walk on the CPU)
equals the unfiltered twin bit for bit, on rays that hit and on rays and
padding that miss, where `bf16`'s miss value is its own; the counts the
filtered bounds take (`variant_prefilter_pairs`, bounds.dense_seconds)
against the rule summed by hand; the launch shapes the reference's block
and tile map to; the combinations the wrapper refuses; and the build's
digest, which covers the header the two ablation kernels share. The
kernels themselves are held to these twins on the card by
tests/test_torch_cuda.py.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from neural_renderer_tpu_torch.ops import (bounds, cuda_build,
                                           trace_ablation, trace_pallas)
from neural_renderer_tpu_torch.ops.trace_pallas import MISS
from neural_renderer_tpu_torch.scene.mesh import outward_sphere

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALK_VARIANTS = ("local", "recip", "recipx", "nodiv", "bf16")


def _operands(n_hit=768, n_away=256, seed=5):
    """Rays from radius 3, `n_hit` aimed near the centre of a 2,304-triangle
    sphere of radius 1 (the ablation's workload in small) and `n_away`
    aimed away from it, against the sphere padded with 256 zero triangles
    (2,560: whole tiles of 128 and 256)."""
    r = np.random.default_rng(seed)
    n = n_hit + n_away
    o = r.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = r.normal(size=(n, 3)) * 0.6 - o
    d[n_hit:] = o[n_hit:] + r.normal(size=(n_away, 3)) * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tris = outward_sphere(24, 48, 1.0).to_tensors("cpu").tris_packed
    tris = torch.nn.functional.pad(tris, (0, 256)).contiguous()
    return (torch.as_tensor(np.ascontiguousarray(o.T, np.float32)),
            torch.as_tensor(np.ascontiguousarray(d.T, np.float32)), tris)


@pytest.mark.parametrize("tile", [128, 256])
@pytest.mark.parametrize("variant", WALK_VARIANTS)
def test_prefiltered_trace_equals_the_twin(variant, tile):
    """The closest hit with the variant's rule in front of its pair math
    (its kernel's walk) equals the unfiltered twin, t and ids, bit for bit:
    on more than 300 rays that hit, on rays that hit nothing (the
    variant's miss value, bf16's own, and id 0) and past the padding."""
    o, d, tris = _operands()
    want = trace_ablation.trace_variant_twin(o, d, tris, variant, tile)
    got = trace_ablation.trace_variant_twin(o, d, tris, variant, tile,
                                            prefilter=True)
    miss = trace_ablation.BF16_MISS if variant == "bf16" else MISS
    hit = want[0] < miss
    assert int(hit[:768].sum()) > 300
    assert not bool(hit[768:].any())
    assert bool((want[0, 768:] == torch.tensor(miss)).all())
    assert bool((want[1, 768:].view(torch.int32) == 0).all())
    assert torch.equal(got, want)


def test_local_walk_is_k3s():
    """`local`'s prefiltered twin is the production dense trace's twin
    (K3's, ANY, every block live), which `local` must equal on the card."""
    o, d, tris = _operands()
    ones = torch.ones(o.shape[1] // 512, dtype=torch.int32)
    k3 = trace_pallas.trace_dense_twin(o, d, tris, 0, ones)
    assert torch.equal(trace_ablation.trace_variant_twin(
        o, d, tris, "local", 128, prefilter=True), k3)


def test_probe_has_no_rule():
    o, d, tris = _operands(64, 0)
    with pytest.raises(ValueError):
        trace_ablation.trace_variant_twin(o, d, tris, "probe", 128,
                                          prefilter=True)


@pytest.mark.parametrize("variant", ["local", "recipx", "nodiv", "bf16"])
def test_filtered_bound_counts_the_rule(variant):
    """`variant_prefilter_pairs` (what the walk rows' filtered bound
    counts) is the rule's facing, u and v tests summed by hand over the
    live rays and the triangles with e1 != 0 (no padding; the walk skips
    it, and every rule rejects a degenerate triangle's det = 0); `local`'s is K3's count; the
    ablation script's bound of each row on its walk is
    bounds.dense_seconds of those counts, beside the per-pair bound."""
    o, d, tris = _operands(512, 0)
    ones = torch.ones(1, dtype=torch.int32)
    real = tris[:, (tris[3:6] != 0).any(dim=0)]   # no padding, no e1 = 0
    face, ku, kv = trace_ablation.variant_prefilter(
        o[:, :, None], d[:, :, None], real[:, None, :], variant)
    got = trace_ablation.variant_prefilter_pairs(o, d, tris, ones, variant)
    assert got == (int(face.sum()), int(ku.sum()), int(kv.sum()))
    assert got[0] == 512 * real.shape[1] and got[1] > got[2] > 0
    if variant == "local":
        assert got == trace_pallas.prefilter_pairs(o, d, tris, ones)
    ablate = _ablate_script()
    pairs = 512 * tris.shape[1]
    labels = [lb for lb, (v, _, _) in trace_ablation.TRACE_COMBOS.items()
              if v == variant]
    for label in labels:
        assert ablate.on_walk(label)
        want = bounds.dense_seconds(pairs, *got, math=variant) * 1e3
        assert ablate.bound_ms(label, pairs, left=got) == want
        assert want < ablate.bound_ms(label, pairs)
    assert ablate.on_walk("current") and not ablate.on_walk("t256probe")


def _ablate_script():
    spec = importlib.util.spec_from_file_location(
        "ablate_trace_kernel_torch",
        os.path.join(ROOT, "scripts", "ablate_trace_kernel_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("label", list(trace_ablation.TRACE_COMBOS))
def test_walk_shapes(label):
    """The reference's (block, tile) as the walk's launch: `local`'s is
    K3's (512-ray CTAs, 64-triangle chunks, 16 CTAs an SM); every row
    holds the rays an SM of K3's launch; every double buffer (12 floats a
    triangle) fits the 48 KiB of static shared memory, t1024's at it."""
    var, block, tile = trace_ablation.TRACE_COMBOS[label]
    rays, chunk, per_sm = trace_ablation.walk_shape(block, tile)
    assert (rays, chunk) == (block, tile // 2)
    assert rays * per_sm == 512 * 16
    assert 2 * chunk * 12 * 4 <= 48 * 1024
    if label == "local":
        assert (rays, chunk, per_sm) == (512, 64, 16)
    if label == "t1024":
        assert 2 * chunk * 12 * 4 == 48 * 1024


@pytest.mark.parametrize("variant, block, tile", [
    ("recip", 256, 128), ("bf16", 512, 256), ("recipx", 1024, 512),
    ("probe", 1024, 128), ("local", 512, 64), ("nodiv", 512, 1024)])
def test_wrapper_refuses_other_combinations(variant, block, tile):
    """A (tile math, block, tile) outside TRACE_COMBOS has no kernel: the
    wrapper raises on every device, before any twin runs."""
    o, d, tris = _operands(1024, 0)
    assert (variant, block, tile) not in trace_ablation.TRACE_COMBOS.values()
    with pytest.raises(ValueError):
        trace_ablation.trace_variant(o, d, tris, variant, block, tile)


def test_build_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """Both ablation kernels include csrc/mt_variants.cuh: an edit there
    renames their libraries (so a stale build never loads), and an edit of
    one kernel's source renames only its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build._CSRC, csrc,
                    ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(cuda_build, "_CSRC", str(csrc))
    names = ("ablate_trace", "ablate_sweep", "trace_dense")
    before = {n: cuda_build._digest(n) for n in names}
    with open(csrc / "mt_variants.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build._digest(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    with open(csrc / "ablate_trace.cu", "a") as f:
        f.write("\n// edited\n")
    again = {n: cuda_build._digest(n) for n in names}
    assert again["ablate_trace"] != after["ablate_trace"]
    assert again["ablate_sweep"] == after["ablate_sweep"]
