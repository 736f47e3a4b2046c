"""Parity of the port's shell traces with the JAX package.

K1 (clustered dual-shell sweep) and K3 (dense closest hit) run here through
their PyTorch twins and are held to `traversal.sweep_shells` /
`traversal.trace_mesh` of the JAX package on the CPU. Shells are the
outward UV spheres (24, 48) of radius 1.2 and 0.8, 4,608 triangles in all,
so the clustered sweep branch runs. The kernels themselves are held to the
twins on the GPU by tests/test_torch_cuda.py.

Tolerance: the JAX functions run under `jax.disable_jit()`, op by op, the
way the port's twins and its -fmad=false kernels evaluate the same
Möller–Trumbore expressions; t then agrees to 1 ulp (measured: 0), hit masks
and triangle ids agree except on FP-grazing rays (at most 1% here). Jitted,
XLA:CPU fuses and contracts the arithmetic and moves t by several ulp
(`test_jitted_pair_math_within_16ulp`).
"""

import numpy as np
import pytest
import torch

import jax

from neural_renderer_tpu.ops import traversal as jtr

from util import outward_sphere

from neural_renderer_tpu_torch.models.convert import mesh_from_numpy
from neural_renderer_tpu_torch.ops import trace_cluster, trace_pallas
from neural_renderer_tpu_torch.ops import traversal as ttr
from neural_renderer_tpu_torch.scene.mesh import HostMesh

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

GRAZE = 0.01


@pytest.fixture(scope="module")
def shells():
    om, im = outward_sphere(24, 48, 1.2), outward_sphere(24, 48, 0.8)
    oa, ia = om.to_arrays(), im.to_arrays()
    port = [mesh_from_numpy(np.asarray(a.tris_packed), a.num_triangles,
                            device="cpu") for a in (oa, ia)]
    own = [HostMesh(m.vertices, m.indices).to_tensors("cpu")
           for m in (om, im)]
    return oa, ia, port, own


def _rays(n=600, seed=7):
    """Rays from a radius-3 sphere toward points within radius 1.3, plus a
    quarter starting between and inside the shells."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(3, n))
    o = 3.0 * o / np.linalg.norm(o, axis=0)
    o[:, : n // 4] *= r.uniform(0.0, 0.45, n // 4)
    target = r.uniform(-1.3, 1.3, size=(3, n))
    d = target - o
    d /= np.linalg.norm(d, axis=0)
    return o.astype(np.float32), d.astype(np.float32)


def _agree_t(a, b, max_ulp=1):
    """Assert two t arrays agree: hits the same except on grazing rays, t
    within max_ulp where both hit. Returns the shared-hit mask and the
    largest difference in ulp."""
    ha, hb = a < 1e30, b < 1e30
    assert (ha != hb).mean() <= GRAZE
    both = ha & hb
    ulps = np.abs(a[both] - b[both]) / np.spacing(np.abs(b[both]))
    worst = float(ulps.max()) if ulps.size else 0.0
    assert worst <= max_ulp
    return both, worst


def test_sweep_twin_matches_jax(shells):
    """All five sweep outputs against the JAX sweep; the 4-row sweep
    (with_fwd2=False) equals the first four rows exactly."""
    oa, ia, port, own = shells
    o, d = _rays()
    with jax.disable_jit():
        ref = jtr.sweep_shells(oa, ia, o, d, with_fwd2=True)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    got = ttr.sweep_shells(port[0], port[1], to, td, with_fwd2=True)
    for f in ttr.ShellSweep._fields:
        _, worst = _agree_t(getattr(got, f).numpy(),
                            np.asarray(getattr(ref, f)))
        print(f"{f}: max {worst} ulp")
    four = ttr.sweep_shells(port[0], port[1], to, td, with_fwd2=False)
    for f in ttr.ShellSweep._fields[:4]:
        assert torch.equal(getattr(four, f), getattr(got, f)), f
    assert (four.outer_fwd2.numpy() == 1e30).all()
    # The port's own leaf order gives bit-identical t's: a min and a strict
    # second-min do not depend on triangle order.
    mine = ttr.sweep_shells(own[0], own[1], to, td, with_fwd2=True)
    for f in ttr.ShellSweep._fields:
        assert torch.equal(getattr(mine, f), getattr(got, f)), f


@pytest.mark.parametrize("mode", [jtr.ANY, jtr.FORWARD_ONLY,
                                  jtr.BACKWARD_ONLY])
def test_dense_trace_twin_matches_jax(shells, mode):
    oa, _, port, _ = shells
    o, d = _rays(seed=8)
    active = np.random.default_rng(9).uniform(size=o.shape[1]) < 0.9
    with jax.disable_jit():
        ref = jtr.trace_mesh(oa, o, d, mode, active=active)
    got = ttr.trace_mesh(port[0], torch.as_tensor(o), torch.as_tensor(d),
                         mode, active=torch.as_tensor(active))
    both, worst = _agree_t(got.t.numpy(), np.asarray(ref.t))
    print(f"mode {mode}: t max {worst} ulp")
    assert not got.hit.numpy()[~active].any()
    same_tri = got.tri.numpy()[both] == np.asarray(ref.tri)[both]
    assert (~same_tri).mean() <= GRAZE
    np.testing.assert_allclose(got.u.numpy()[both][same_tri],
                               np.asarray(ref.u)[both][same_tri],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.hit.numpy(), got.t.numpy() < 1e30)


def test_jitted_pair_math_within_16ulp(shells):
    """Jitted, XLA:CPU fuses and contracts the Möller–Trumbore expressions:
    pair t's move by up to 7 ulp against the op-by-op evaluation on these
    rays (printed; run with -s), an amount that depends on where the CPU
    backend fuses multiply-adds; held to 16. Hit decisions agree but for
    grazing pairs."""
    oa, _, port, _ = shells
    o, d = _rays(n=300)
    tp = np.asarray(oa.tris_packed)

    def pair_t(o, d, tp):
        t, _, _, ok = jtr._mt_from_packed(
            o[:, :, None], d[:, :, None], tp[0:3][:, None, :],
            tp[3:6][:, None, :], tp[6:9][:, None, :], jtr.ANY)
        return jax.numpy.where(ok & (t > jtr.MIN_T), t, 1e30)

    ref = np.asarray(jax.jit(pair_t)(o, d, tp))
    got, _ = trace_pallas._mt_tile_t(torch.as_tensor(o), torch.as_tensor(d),
                                     port[0].tris_packed)
    _, worst = _agree_t(got.numpy(), ref, max_ulp=16)
    print(f"jitted pair t: max {worst} ulp")


def test_worklist_lists_clusters_in_order(shells):
    """Level 0: each 512-ray block lists exactly the clusters its rays' slabs
    enter, ascending (outer shell first), padded to STREAM_K per row."""
    _, _, port, _ = shells
    o, d = _rays(n=1024)
    ops = ttr.clustered_sweep_operands(port[0], port[1], torch.as_tensor(o),
                                       torch.as_tensor(d))
    _, _, tp, ids, counts, co = ops
    mask = trace_cluster._block_cluster_mask(
        ops[0], ops[1], torch.cat([port[0].cluster_bounds,
                                   port[1].cluster_bounds], dim=1), None)
    rows = ids.reshape(-1, trace_cluster.STREAM_K)
    for b in range(rows.shape[0]):
        listed = rows[b, :counts[b]].tolist()
        assert listed == torch.nonzero(mask[b]).squeeze(1).tolist()
    assert co == port[0].cluster_bounds.shape[1]
    assert tp.shape[1] == (co + port[1].cluster_bounds.shape[1]) * 256


def test_unported_branches_raise():
    """No branch of trace_mesh or sweep_shells raises NotImplementedError
    any more. The branches that used to (small shells: the dense sweep; a
    mesh above 4,096 triangles: the clustered trace; shells above 16,384
    triangles or no outer shell: one trace per row) agree with each other
    where their domains meet."""
    o, d = (torch.as_tensor(x) for x in _rays(n=64))
    small_o = HostMesh(*_sphere_arrays(8, 16, 1.2)).to_tensors("cpu")
    small_i = HostMesh(*_sphere_arrays(8, 16, 0.8)).to_tensors("cpu")
    dense = ttr.sweep_shells(small_o, small_i, o, d, with_fwd2=True)
    per_mesh = ttr._sweep_per_mesh(small_o, small_i, o, d, True)
    for f in ttr.ShellSweep._fields[:4]:
        assert torch.equal(getattr(dense, f), getattr(per_mesh, f)), f
    # A convex shell has one forward crossing: no second one on either path.
    assert (dense.outer_fwd2 == 1e30).all()
    assert (per_mesh.outer_fwd2 == 1e30).all()
    # No outer shell: the inner rows alone.
    empty = HostMesh().to_tensors("cpu")
    no_outer = ttr.sweep_shells(empty, small_i, o, d)
    assert (no_outer.outer_fwd == 1e30).all()
    assert torch.equal(no_outer.inner_fwd, dense.inner_fwd)
    assert (ttr.sweep_shells(empty, empty, o, d).inner_bwd == 1e30).all()
    # Above 4,096 triangles: the clustered trace, equal to the oracle.
    big = HostMesh(*_sphere_arrays(40, 60, 1.0)).to_tensors("cpu")
    assert big.num_triangles > 4096
    got = ttr.trace_mesh(big, o, d)
    ref = ttr.trace_mesh_brute(big, o, d)
    assert torch.equal(got.t, ref.t) and got.hit.sum() > 10
    assert torch.equal(got.tri[ref.hit], ref.tri[ref.hit])
    # Above 16,384 triangles the sweep goes row by row through that trace.
    huge_o = HostMesh(*_sphere_arrays(96, 96, 1.2)).to_tensors("cpu")
    assert huge_o.num_triangles > ttr.DENSE_MAX_TRIANGLES
    rows = ttr.sweep_shells(huge_o, small_i, o, d, with_fwd2=True)
    hit = (rows.outer_fwd < 1e30) & (dense.outer_fwd < 1e30)
    assert hit.sum() > 10
    # The 256-triangle polyhedron lies up to ~0.1 inside the fine sphere.
    assert torch.allclose(rows.outer_fwd[hit], dense.outer_fwd[hit],
                          atol=0.15)
    assert torch.equal(rows.inner_bwd, dense.inner_bwd)


def _sphere_arrays(stacks, slices, radius):
    m = outward_sphere(stacks, slices, radius)
    return m.vertices, m.indices
