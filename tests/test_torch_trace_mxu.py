"""The port's matrix formulation of the traces (NR_TRACE_MXU=1) against
the JAX package's, on the CPU.

The feature rows are bit-exact against JAX's, run op by op. The twins of
the four matrix-formulation kernels (K8, and the MXU bodies of K1, K4, K5)
are held against the JAX kernels run in Pallas interpret mode on the same
inputs, worklists and tiles carried across, to the JAX package's own
kernel-against-twin bounds (tests/test_trace_mxu.py:128-136): hit flips
under 2e-3, t within 1e-6 relative and absolute where both hit, ids equal on
99.9%. The port's twins round FP64 products to f32 (as its kernels do),
XLA's dot sums f32 products, so t differs by a few ulp. K5's ids may
differ only where two triangles tie in t: the port keeps the oracle's rule
(smallest id), the interpreted TPU kernel the first visited (ROADMAP Queue
3). With NR_TRACE_MXU=1 the port's `trace_mesh` and `sweep_shells` take the
MXU wrappers (spied) and agree with `trace_mesh_brute` to the JAX package's
MXU-against-oracle bounds (tests/test_trace_mxu.py:73-83, :204-212): flips
under 2e-3, t within 1e-5 relative and 1e-6 absolute, ids equal on 99%.
The whole MXU frame is in tests/test_torch_frame.py. Figures print with -s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.ops import trace_cluster as jtc
from neural_renderer_tpu.ops import trace_mxu as jtm
from neural_renderer_tpu.ops import trace_pallas as jtp

from util import outward_sphere, two_lobe_sphere

from neural_renderer_tpu_torch.models import convert
from neural_renderer_tpu_torch.ops import (trace_cluster, trace_mxu,
                                           trace_pallas, traversal)
from neural_renderer_tpu_torch.scene.mesh import outward_sphere as port_sphere

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

KERNEL_BOUNDS = dict(rtol=1e-6, atol=1e-6, ids=0.999)
ORACLE_BOUNDS = dict(rtol=1e-5, atol=1e-6, ids=0.99)


def _rays(n, seed=1):
    """tests/test_trace_mxu.py's rays: origins on a radius-3 sphere aimed at
    points near the centre; [3, N] f32 numpy."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0
    d = rng.normal(size=(n, 3)) * 0.6 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.T.astype(np.float32).copy(), d.T.astype(np.float32).copy()


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _hold(label, t_a, t_b, bounds, ids_a=None, ids_b=None, min_hits=200):
    a = trace_mxu.agreement(_t(t_a), _t(t_b),
                            None if ids_a is None else _t(ids_a),
                            None if ids_b is None else _t(ids_b),
                            bounds["rtol"], bounds["atol"])
    print(f"{label}: flips {a['flips']:.2e}, both hit {a['both']}, max rel "
          f"t {a['max_rel']:.2e}, ids {a['ids']:.5f}")
    assert a["flips"] < 2e-3 and a["both"] >= min_hits, a
    assert a["within"] and a["ids"] >= bounds["ids"], a


def _padded(tp, width):
    pad = -(-tp.shape[1] // width) * width - tp.shape[1]
    return np.pad(tp, ((0, 0), (0, pad)))


def test_features_bit_exact():
    mesh = outward_sphere(8, 16, 1.0).to_arrays()
    o, d = _rays(256, seed=3)
    tp = np.asarray(mesh.tris_packed)
    with jax.disable_jit():
        jf = jtm.ray_features(jnp.asarray(o), jnp.asarray(d))
        jt = jtm.tri_features(jnp.asarray(tp))
    assert torch.equal(trace_mxu.ray_features(_t(o), _t(d)), _t(jf))
    for got, want in zip(trace_mxu.tri_features(_t(tp)), jt):
        assert torch.equal(got, _t(want))


@pytest.mark.parametrize("mode", [traversal.ANY, traversal.FORWARD_ONLY,
                                  traversal.BACKWARD_ONLY])
def test_dense_twin_matches_interpreted_kernel(mode):
    """K8's twin against `trace_dense_mxu_pallas(interpret=True)`."""
    mesh = outward_sphere(8, 16, 1.0).to_arrays()
    tp = _padded(np.asarray(mesh.tris_packed), jtp.TRI_TILE)
    o, d = _rays(1024, seed=5)
    bt, bid = jtm.trace_dense_mxu_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tp), mode,
        tp.shape[1] // jtp.TRI_TILE, interpret=True)
    out = trace_pallas.trace_dense_twin(
        _t(o), _t(d), _t(tp), mode, torch.ones(2, dtype=torch.int32),
        mxu=True)
    _hold(f"K8 twin mode {mode}", out[0], bt, KERNEL_BOUNDS,
          out[1].view(torch.int32), bid)


def _shell_pair(stacks, slices):
    return (outward_sphere(stacks, slices, 1.2).to_arrays(),
            outward_sphere(stacks, slices, 0.8).to_arrays())


def test_clustered_sweep_twin_matches_interpreted_kernel():
    """K1-MXU's twin against `sweep_clusters_stream(mxu=True,
    interpret=True)` on JAX's own worklists; all five rows."""
    outer, inner = _shell_pair(24, 48)
    o, d = _rays(1024, seed=11)
    co = outer.cluster_bounds.shape[1]
    ci = inner.cluster_bounds.shape[1]
    cb = jnp.concatenate([outer.cluster_bounds, inner.cluster_bounds], axis=1)
    tp = np.concatenate([
        _padded(np.asarray(m.tris_packed), jtc.CLUSTER_SIZE)[
            :, :c * jtc.CLUSTER_SIZE] for m, c in ((outer, co), (inner, ci))],
        axis=1)
    mask = jtc._block_cluster_mask(jnp.asarray(o), jnp.asarray(d), cb, None)
    ids, _, counts, _ = jtc._stream_worklist(
        mask, jnp.where(mask, 0.0, jnp.inf), jtc.STREAM_K)
    ref = jtc.sweep_clusters_stream(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(tp), ids, counts, co,
                                    with_fwd2=True, mxu=True, interpret=True)
    got = trace_cluster.sweep_clusters_twin(_t(o), _t(d), _t(tp), _t(ids),
                                            _t(counts), co, True, mxu=True)
    for row in range(5):   # row 4 (outer_fwd2) has no hits on convex shells
        _hold(f"K1-MXU twin row {row}", got[row], np.asarray(ref[row]),
              KERNEL_BOUNDS, min_hits=100 if row < 4 else 0)


def test_dense_sweep_twin_matches_interpreted_kernel():
    """K4-MXU's twin against `sweep_shells_pallas(mxu=True,
    interpret=True)` on the same tiles; all five rows."""
    outer, inner = _shell_pair(10, 20)
    o, d = _rays(512, seed=17)
    tpo = _padded(np.asarray(outer.tris_packed), jtp.SWEEP_TRI_TILE)
    tpi = _padded(np.asarray(inner.tris_packed), jtp.SWEEP_TRI_TILE)
    tp = np.concatenate([tpo, tpi], axis=1)
    to = tpo.shape[1] // jtp.SWEEP_TRI_TILE
    ref = jtp.sweep_shells_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tp), to,
        tp.shape[1] // jtp.SWEEP_TRI_TILE, with_fwd2=True, mxu=True,
        interpret=True)
    got = trace_pallas.sweep_shells_dense_twin(
        _t(o), _t(d), _t(tp), tpo.shape[1], True,
        torch.ones(1, dtype=torch.int32), mxu=True)
    for row in range(5):   # row 4 (outer_fwd2) has no hits on convex shells
        _hold(f"K4-MXU twin row {row}", got[row], np.asarray(ref[row]),
              KERNEL_BOUNDS, min_hits=50 if row < 4 else 0)


@pytest.mark.parametrize("mode", [traversal.ANY, traversal.FORWARD_ONLY])
def test_clustered_trace_twin_matches_interpreted_kernel(mode):
    """K5-MXU's twin against `trace_clusters_stream(mxu=True,
    interpret=True)` on JAX's front-to-back worklists; ids may differ only
    at equal-t ties."""
    mesh = outward_sphere(24, 48, 1.0).to_arrays()
    o, d = _rays(1024, seed=13)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    c = mesh.cluster_bounds.shape[1]
    tp = _padded(np.asarray(mesh.tris_packed), jtc.CLUSTER_SIZE)[
        :, :c * jtc.CLUSTER_SIZE]
    mask, btmin = jtc._block_cluster_mask(oj, dj, mesh.cluster_bounds, None,
                                          with_tmin=True)
    ids, tmins, counts, _ = jtc._stream_worklist(mask, btmin, jtc.STREAM_K)
    exit_t = jtc.mesh_exit_t(oj, dj, mesh.cluster_bounds, None)
    bt, bid = jtc.trace_clusters_stream(oj, dj, jnp.asarray(tp), ids, tmins,
                                        counts, exit_t, mode, mxu=True,
                                        interpret=True)
    gt, gid = trace_cluster.trace_clusters_twin(
        _t(o), _t(d), _t(tp), _t(ids), _t(tmins), _t(counts), _t(exit_t),
        mode, mxu=True)
    _hold(f"K5-MXU twin mode {mode}", gt, bt, dict(KERNEL_BOUNDS, ids=0.0),
          min_hits=300)
    bt, bid = np.asarray(bt), np.asarray(bid)
    differ = (gt.numpy() < 1e30) & (bt < 1e30) & (gid.numpy() != bid)
    if differ.any():
        # The interpreted kernel's triangle gives the same t as the port's.
        idx = np.nonzero(differ)[0]
        other = trace_mxu.mxu_tile_t(_t(o[:, idx]), _t(d[:, idx]),
                                     _t(tp[:, bid[idx]]))[0]
        assert torch.equal(other.diagonal(), gt[idx])
    print(f"K5-MXU twin mode {mode}: {int(differ.sum())} ids differ at ties")


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


def test_dispatch_takes_mxu_and_matches_brute(monkeypatch):
    """NR_TRACE_MXU=1: the dense and two-level `trace_mesh` and the
    clustered and dense `sweep_shells` go through the MXU wrappers and agree
    with `trace_mesh_brute`; the block-masked dense trace equals the
    unmasked one exactly. The branch thresholds are lowered so that small
    meshes take every branch (the brute-force loop costs one step per
    triangle): 256 triangles trace dense, 576 two-level; shells of 400 + 400
    sweep dense, 576 + 576 clustered."""
    monkeypatch.setenv("NR_TRACE_MXU", "1")
    monkeypatch.setattr(traversal, "_CLUSTERED_TRACE_MIN_TRIS", 256)
    monkeypatch.setattr(traversal, "_CLUSTERED_SWEEP_MIN_TRIS", 1000)
    spies = {"trace_dense_mxu": trace_mxu, "trace_clusters_stream_mxu":
             trace_cluster, "sweep_clusters_stream_mxu": trace_cluster,
             "sweep_shells_dense_mxu": trace_pallas}
    calls = {name: _spy(monkeypatch, mod, name)
             for name, mod in spies.items()}
    o, d = _rays(1536, seed=19)
    o[:, :512] = 3.0 * d[:, :512]       # pointing away: a skipped block
    ot, dt = _t(o), _t(d)

    def mesh(stacks, slices, radius):
        return port_sphere(stacks, slices, radius).to_tensors("cpu")

    for m, kernel in ((mesh(8, 16, 1.0), "trace_dense_mxu"),
                      (mesh(12, 24, 1.0), "trace_clusters_stream_mxu")):
        for mode in (traversal.ANY, traversal.FORWARD_ONLY):
            before = len(calls[kernel])
            got = traversal.trace_mesh(m, ot, dt, mode)
            assert len(calls[kernel]) == before + 1
            ref = traversal.trace_mesh_brute(m, ot, dt, mode)
            _hold(f"{kernel} mode {mode} vs brute", got.t, ref.t,
                  ORACLE_BOUNDS, got.tri, ref.tri, min_hits=600)
    ops = traversal.dense_trace_operands(mesh(8, 16, 1.0), ot, dt)
    assert ops[3].min().item() == 0
    masked = trace_pallas.trace_dense(*ops[:3], traversal.ANY, ops[3])
    unmasked = trace_pallas.trace_dense(*ops[:3], traversal.ANY,
                                        torch.ones_like(ops[3]))
    assert torch.equal(masked, unmasked)

    for stacks, slices, kernel in ((12, 24, "sweep_clusters_stream_mxu"),
                                   (10, 20, "sweep_shells_dense_mxu")):
        outer, inner = mesh(stacks, slices, 1.2), mesh(stacks, slices, 0.8)
        before = len(calls[kernel])
        sw = traversal.sweep_shells(outer, inner, ot, dt, with_fwd2=True)
        assert len(calls[kernel]) == before + 1
        for row, m, mode in ((0, outer, traversal.FORWARD_ONLY),
                             (1, outer, traversal.BACKWARD_ONLY),
                             (2, inner, traversal.FORWARD_ONLY),
                             (3, inner, traversal.BACKWARD_ONLY)):
            ref = traversal.trace_mesh_brute(m, ot, dt, mode)
            _hold(f"{kernel} row {row} vs brute", sw[row], ref.t,
                  ORACLE_BOUNDS, min_hits=300)

    # The strict second forward crossing needs a non-convex outer shell:
    # two lobes on the x axis, rays along it, against the default
    # formulation.
    rng = np.random.default_rng(23)
    ox = np.stack([np.full(512, -3.0), *rng.uniform(-0.3, 0.3, (2, 512))])
    dx = np.stack([np.ones(512), *rng.uniform(-0.05, 0.05, (2, 512))])
    ot = _t((ox).astype(np.float32))
    dt = _t((dx / np.linalg.norm(dx, axis=0)).astype(np.float32))
    for stacks, kernel in ((12, "sweep_clusters_stream_mxu"),
                           (8, "sweep_shells_dense_mxu")):
        lobes = two_lobe_sphere(0.5, 0.6, stacks, 2 * stacks).to_arrays()
        outer = convert.mesh_from_numpy(np.asarray(lobes.tris_packed),
                                        lobes.num_triangles, device="cpu")
        inner = mesh(4, 8, 0.3)
        before = len(calls[kernel])
        sw = traversal.sweep_shells(outer, inner, ot, dt, with_fwd2=True)
        assert len(calls[kernel]) == before + 1
        monkeypatch.setenv("NR_TRACE_MXU", "0")
        ref = traversal.sweep_shells(outer, inner, ot, dt, with_fwd2=True)
        monkeypatch.setenv("NR_TRACE_MXU", "1")
        _hold(f"{kernel} outer_fwd2 vs default", sw.outer_fwd2,
              ref.outer_fwd2, ORACLE_BOUNDS, min_hits=300)
