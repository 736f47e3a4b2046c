"""Parity of the port's ground-truth path with the JAX package, on the CPU.

The clustered closest hit (K5) and the dense dual-shell sweep (K4) run here
through their PyTorch twins. Inputs come from numpy seeds; meshes are built
once by the JAX package and carried across with `mesh_from_numpy`, so both
sides number triangles alike (each package's own BVH build gives another
leaf order).

Tolerances. Where the JAX side runs op by op (`jax.disable_jit()`), both
sides evaluate the same float32 expressions in the same order: t agrees to
1 ulp (measured 0) and sweep rows exactly. Where the JAX side must be
jitted (a `pallas_call` in interpret mode, the brute-force loop), XLA:CPU
contracts multiply-adds and t moves by a few ulp: held to 16. Triangle ids
agree except where two triangles tie in t (shared edges): the port keeps
the oracle's rule, smallest id, while the interpreted TPU kernel keeps the
first visited of two equal-t triangles that share a lane; hit masks may
differ on FP-grazing rays (at most 1%).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.ops import intersect as jint
from neural_renderer_tpu.ops import trace_cluster as jtc
from neural_renderer_tpu.ops import trace_pallas as jtp
from neural_renderer_tpu.ops import traversal as jtr

from util import outward_sphere

from neural_renderer_tpu_torch.models.convert import mesh_from_numpy
from neural_renderer_tpu_torch.ops import intersect as tint
from neural_renderer_tpu_torch.ops import trace_cluster as ttc
from neural_renderer_tpu_torch.ops import trace_pallas as ttp
from neural_renderer_tpu_torch.ops import traversal as ttr

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAZE = 0.01
MODES = [jtr.ANY, jtr.FORWARD_ONLY, jtr.BACKWARD_ONLY]


def carry(a):
    """A JAX MeshArrays as the port's MeshTensors, same triangle order."""
    n = np.asarray
    return mesh_from_numpy(
        n(a.tris_packed), a.num_triangles, device="cpu",
        vertices=n(a.vertices), normals=n(a.normals), uvs=n(a.uvs),
        indices=n(a.indices), tri_material=n(a.tri_material),
        nodes_packed=n(a.nodes_packed), mat_scalars=n(a.mat_scalars),
        has_normals=a.has_normals, has_uvs=a.has_uvs,
        has_materials=a.has_materials, max_leaf=a.max_leaf)


@pytest.fixture(scope="module")
def sphere():
    a = outward_sphere(48, 96, 1.0).to_arrays()   # 9,216 triangles
    return a, carry(a)


def _rays(n, seed):
    """Rays from a radius-3 sphere toward points within radius 1.3, a
    quarter of them starting inside."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(3, n))
    o = 3.0 * o / np.linalg.norm(o, axis=0)
    o[:, : n // 4] *= r.uniform(0.0, 0.3, n // 4)
    d = r.uniform(-1.3, 1.3, size=(3, n)) - o
    d /= np.linalg.norm(d, axis=0)
    return o.astype(np.float32), d.astype(np.float32)


def _ulps(a, b):
    return np.abs(a - b) / np.spacing(np.abs(b))


def _agree(got_t, got_tri, ref_t, ref_tri, tris_packed, o, d, max_ulp):
    """t within max_ulp where both hit, hit masks equal but for grazing
    rays, ids equal except where the other id's triangle gives the same t
    within max_ulp (a tie)."""
    hg, hr = got_t < 1e30, ref_t < 1e30
    assert (hg != hr).mean() <= GRAZE
    both = hg & hr
    assert both.sum() > 100
    worst = float(_ulps(got_t[both], ref_t[both]).max())
    assert worst <= max_ulp, worst
    differ = both & (got_tri != ref_tri)
    if differ.any():
        idx = np.nonzero(differ)[0]
        tb = torch.as_tensor(tris_packed[:, ref_tri[idx]])
        t_other, _, _, ok = ttr._mt_from_packed(
            torch.as_tensor(o[:, idx]), torch.as_tensor(d[:, idx]), tb[0:3],
            tb[3:6], tb[6:9], ttr.ANY)
        assert bool(ok.all())
        assert (_ulps(t_other.numpy(), got_t[idx]) <= max(max_ulp, 4)).all()
    return worst, int(differ.sum())


@pytest.mark.parametrize("use_active", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_clustered_trace_matches_jax_op_by_op(sphere, mode, use_active):
    """trace_mesh above 4,096 triangles: the port takes the sort, the
    worklists and the K5 twin; CPU JAX, op by op, its dense XLA branch."""
    a, m = sphere
    o, d = _rays(1024, seed=21)
    active = (np.random.default_rng(3).uniform(size=1024) < 0.8
              if use_active else None)
    with jax.disable_jit():
        ref = jtr.trace_mesh(a, o, d, mode, active=active)
    got = ttr.trace_mesh(m, torch.as_tensor(o), torch.as_tensor(d), mode,
                         active=None if active is None
                         else torch.as_tensor(active))
    worst, ties = _agree(got.t.numpy(), got.tri.numpy(), np.asarray(ref.t),
                         np.asarray(ref.tri), np.asarray(a.tris_packed), o, d,
                         max_ulp=1)
    print(f"mode {mode} active {use_active}: t max {worst} ulp, {ties} ties")
    if active is not None:
        assert not got.hit.numpy()[~active].any()
    same = (got.tri.numpy() == np.asarray(ref.tri)) & got.hit.numpy() \
        & np.asarray(ref.hit)
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(ref.u)[same],
                               rtol=1e-5, atol=1e-6)


def _k5_operands(m, o, d, active=None, kmax=ttc.STREAM_K):
    return ttr.clustered_trace_operands(
        m, torch.as_tensor(o), torch.as_tensor(d),
        None if active is None else torch.as_tensor(active), kmax)


@pytest.mark.parametrize("mode", MODES)
def test_clustered_trace_twin_matches_interpreted_kernel(sphere, mode):
    """The K5 twin against the TPU kernel in interpret mode on the same
    worklists (carried across), and the port's worklists against JAX's."""
    a, m = sphere
    o, d = _rays(1024, seed=13)
    op, dp, tp, ids, tmins, counts, exit_t, overflow = _k5_operands(m, o, d)
    mask, btmin = jtc._block_cluster_mask(o, d, a.cluster_bounds, None,
                                          with_tmin=True)
    jids, jtm, jcnt, jover = jtc._stream_worklist(mask, btmin, jtc.STREAM_K)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcnt))
    assert not overflow.any() and not np.asarray(jover).any()
    for b in range(counts.shape[0]):
        c = int(counts[b])
        row = slice(b * ttc.STREAM_K, b * ttc.STREAM_K + c)
        assert sorted(ids[row].tolist()) == sorted(np.asarray(jids)[row]
                                                   .tolist())
        np.testing.assert_allclose(tmins[row].numpy(), np.asarray(jtm)[row],
                                   rtol=1e-5, atol=1e-6)
    jexit = jtc.mesh_exit_t(o, d, a.cluster_bounds, None)
    np.testing.assert_allclose(exit_t.numpy(), np.asarray(jexit), rtol=1e-5,
                               atol=1e-6)
    bt, btri = jtc.trace_clusters_stream(
        jnp.asarray(op.numpy()), jnp.asarray(dp.numpy()),
        jnp.asarray(tp.numpy()), jnp.asarray(ids.numpy()),
        jnp.asarray(tmins.numpy()), jnp.asarray(counts.numpy()),
        jnp.asarray(exit_t.numpy()), mode, mxu=False, interpret=True)
    gt, gtri = ttc.trace_clusters_twin(op, dp, tp, ids, tmins, counts, exit_t,
                                       mode)
    worst, ties = _agree(gt.numpy(), gtri.numpy(), np.asarray(bt),
                         np.asarray(btri), tp.numpy(), o, d, max_ulp=16)
    print(f"mode {mode}: t max {worst} ulp vs interpreted kernel, "
          f"{ties} ties")


@pytest.mark.parametrize("mode", MODES)
def test_clustered_trace_break_and_oracle(sphere, mode):
    """The break changes the work, never a result: twin with and without it
    agree exactly, both equal the port's brute-force oracle exactly, and the
    break does save clusters where the near side can hit; JAX's (jitted)
    oracle agrees within 16 ulp."""
    a, m = sphere
    o, d = _rays(1024, seed=5)
    # The second block is a coherent bundle that hits the near side, so its
    # far-side clusters lie beyond the bound.
    r = np.random.default_rng(6)
    o[:, 512:] = np.array([[0.0], [0.0], [3.0]], np.float32)
    target = np.concatenate([r.uniform(-0.4, 0.4, size=(2, 512)),
                             np.zeros((1, 512))])
    d[:, 512:] = target - o[:, 512:]
    d /= np.linalg.norm(d, axis=0)
    op, dp, tp, ids, tmins, counts, exit_t, _ = _k5_operands(m, o, d)
    swept = torch.zeros_like(counts)
    t1, tri1 = ttc.trace_clusters_twin(op, dp, tp, ids, tmins, counts,
                                       exit_t, mode, True, swept)
    swept_all = torch.zeros_like(counts)
    t0, tri0 = ttc.trace_clusters_twin(op, dp, tp, ids, tmins, counts,
                                       exit_t, mode, False, swept_all)
    assert torch.equal(t1, t0) and torch.equal(tri1, tri0)
    assert torch.equal(swept_all, counts)
    assert (swept <= counts).all()
    if mode != jtr.BACKWARD_ONLY:   # back faces lie on the far side
        assert int(swept[1]) < int(counts[1])
    brute = ttr.trace_mesh_brute(m, torch.as_tensor(o), torch.as_tensor(d),
                                 mode)
    assert torch.equal(t1, brute.t)
    hit = brute.hit
    assert torch.equal(tri1.to(torch.int64)[hit], brute.tri[hit])
    ref = jtr.trace_mesh_brute(a, o, d, mode)
    _agree(t1.numpy(), tri1.numpy(), np.asarray(ref.t), np.asarray(ref.tri),
           tp.numpy(), o, d, max_ulp=16)


def test_overflow_takes_bvh_walk(sphere):
    """A worklist cut at a small capacity flags its block, whose rays the
    BVH walk re-traces: the result still equals the uncut trace. The walk
    alone matches JAX's, op for op."""
    a, m = sphere
    o, d = _rays(1024, seed=9)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    *_, overflow = _k5_operands(m, o, d, kmax=2)
    assert overflow.any()
    cut = ttr._trace_two_level_impl(m, to, td, ttr.ANY, None, kmax=2)
    full = ttr._trace_two_level_impl(m, to, td, ttr.ANY, None)
    assert torch.equal(cut.hit, full.hit)
    both = full.hit.numpy()
    assert (_ulps(cut.t.numpy()[both], full.t.numpy()[both]) <= 1).all()
    active = np.random.default_rng(1).uniform(size=256) < 0.9
    ref = jtr._trace_bvh(a, o[:, :256], d[:, :256], jtr.ANY,
                         jnp.asarray(active))
    got = ttr._trace_bvh(m, to[:, :256], td[:, :256], ttr.ANY,
                         torch.as_tensor(active))
    _agree(got.t.numpy(), got.tri.numpy(), np.asarray(ref.t),
           np.asarray(ref.tri), np.asarray(a.tris_packed), o[:, :256],
           d[:, :256], max_ulp=16)
    assert not got.hit.numpy()[~active].any()


# ---------------------------------------------------------------------------
# K4: dense dual-shell sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_shells():
    oa = outward_sphere(10, 20, 1.2).to_arrays()   # 400 triangles each
    ia = outward_sphere(10, 20, 0.8).to_arrays()
    return oa, ia, carry(oa), carry(ia)


def _shell_rays(n, seed):
    o, d = _rays(n, seed)
    # The last 512-ray block points away from the shells: a dead block.
    d[:, -512:] = o[:, -512:] / np.linalg.norm(o[:, -512:], axis=0)
    o[:, -512:] = 3.0 * d[:, -512:]
    return o, d


@pytest.mark.parametrize("with_fwd2", [True, False])
def test_dense_sweep_matches_jax_op_by_op(small_shells, with_fwd2):
    """sweep_shells on shells under 4,096 triangles: the port takes the K4
    twin with the root-AABB skip flags; CPU JAX, op by op, its dense
    t-only branch. Every row exact."""
    oa, ia, om, im = small_shells
    o, d = _shell_rays(1536, seed=17)
    with jax.disable_jit():
        ref = jtr.sweep_shells(oa, ia, o, d, with_fwd2=with_fwd2)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    got = ttr.sweep_shells(om, im, to, td, with_fwd2=with_fwd2)
    for f in ttr.ShellSweep._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    *_, block_mask = ttr.dense_sweep_operands(om, im, to, td)
    assert block_mask.tolist() == [1, 1, 0]
    assert (got.outer_fwd.numpy()[-512:] == 1e30).all()


def test_dense_sweep_twin_matches_interpreted_kernel(small_shells):
    """The K4 twin against the TPU kernel in interpret mode on the same
    operands, dead block included. The interpreted kernel is jitted: 16
    ulp."""
    oa, ia, om, im = small_shells
    o, d = _shell_rays(1024, seed=19)
    op, dp, tp, outer_cols, bm = ttr.dense_sweep_operands(
        om, im, torch.as_tensor(o), torch.as_tensor(d))
    tile = jtp.SWEEP_TRI_TILE
    assert ttp.SWEEP_TRI_TILE == tile
    ref = jtp.sweep_shells_pallas(
        jnp.asarray(op.numpy()), jnp.asarray(dp.numpy()),
        jnp.asarray(tp.numpy()), outer_cols // tile, tp.shape[1] // tile,
        with_fwd2=True, mxu=False, interpret=True,
        block_mask=jnp.asarray(bm.numpy()))
    got = ttp.sweep_shells_dense_twin(op, dp, tp, outer_cols, True, bm)
    assert got.shape == (5, 1024)
    for row in range(5):
        g, r = got[row].numpy(), np.asarray(ref[row])
        hg, hr = g < 1e30, r < 1e30
        assert (hg != hr).mean() <= GRAZE, row
        both = hg & hr
        assert (_ulps(g[both], r[both]) <= 16).all(), row
    four = ttp.sweep_shells_dense_twin(op, dp, tp, outer_cols, False, bm)
    assert torch.equal(four, got[:4])


def test_dense_sweep_empty_inner(small_shells):
    """No inner shell: rows 2-3 are misses, the outer rows those of the full
    sweep."""
    oa, _, om, im = small_shells
    empty = mesh_from_numpy(np.zeros((9, 1), np.float32), 0, device="cpu")
    o, d = _shell_rays(1024, seed=23)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    got = ttr.sweep_shells(om, empty, to, td, with_fwd2=True)
    full = ttr.sweep_shells(om, im, to, td, with_fwd2=True)
    for f in ("outer_fwd", "outer_bwd", "outer_fwd2"):
        assert torch.equal(getattr(got, f), getattr(full, f)), f
    assert (got.inner_fwd == 1e30).all() and (got.inner_bwd == 1e30).all()


# ---------------------------------------------------------------------------
# Hit data, materials, the ground-truth frame
# ---------------------------------------------------------------------------

def test_hit_data_and_material_match_jax(sphere):
    a, m = sphere
    o, d = _rays(512, seed=31)
    with jax.disable_jit():
        res = jtr.trace_mesh(a, o, d, jtr.ANY)
        hd = jint.compute_hit_data(a, o, d, res.tri, res.u, res.v, res.t)
        row = jnp.arange(18, dtype=jnp.float32) * 0.05
        rm = jint.resolve_material(a, hd.material_id, hd.uv, row)
    t = torch.as_tensor
    ghd = tint.compute_hit_data(
        m, t(o), t(d), t(np.asarray(res.tri).astype(np.int64)),
        t(np.array(res.u)), t(np.array(res.v)), t(np.array(res.t)))
    for f in ("position", "shading_normal", "geometric_normal", "uv"):
        np.testing.assert_allclose(getattr(ghd, f).numpy(),
                                   np.asarray(getattr(hd, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(ghd.material_id.numpy(),
                                  np.asarray(hd.material_id))
    grm = tint.resolve_material(m, ghd.material_id, ghd.uv,
                                t(np.asarray(row)))
    for f in rm._fields:
        np.testing.assert_array_equal(getattr(grm, f).numpy(),
                                      np.asarray(getattr(rm, f)), err_msg=f)


def test_per_mesh_constant_materials(sphere):
    """A mesh with two constant materials: material ids pick the mesh's row,
    -1 the global row."""
    _, m = sphere
    import dataclasses
    rows = np.stack([np.full(18, 0.25, np.float32),
                     np.full(18, 0.75, np.float32)], axis=1)
    tm = np.where(np.arange(m.num_triangles) % 3 == 0, -1,
                  np.arange(m.num_triangles) % 2)
    mm = dataclasses.replace(m, has_materials=True,
                             mat_scalars=torch.as_tensor(rows),
                             tri_material=torch.as_tensor(tm))
    tri = torch.arange(0, 600, dtype=torch.int64)
    z = torch.zeros(600)
    hd = tint.compute_hit_data(mm, torch.zeros(3, 600), torch.ones(3, 600),
                               tri, z, z, z)
    rm = tint.resolve_material(mm, hd.material_id, hd.uv,
                               torch.full((18,), 0.5))
    want = np.where(tm[:600] < 0, 0.5, np.where(tm[:600] == 0, 0.25, 0.75))
    np.testing.assert_array_equal(rm.roughness.numpy(), want.astype(
        np.float32))
    np.testing.assert_array_equal(rm.base_color[1].numpy(), want.astype(
        np.float32))


def _image_close(img, ref):
    """tests/test_golden.py's tolerance off the recording platform."""
    assert img.shape == ref.shape
    diff = np.abs(img.astype(int) - ref.astype(int))
    assert diff.max() <= 2
    assert (diff.sum(axis=-1) > 0).mean() < 0.05


def test_gt_frame_matches_jax():
    """render_gt_frame at 32x24, 2 bounces, on configs/sphere/original.obj
    (9,216 triangles) against the JAX frame under jax.disable_jit()."""
    from neural_renderer_tpu.config import load_config
    from neural_renderer_tpu.render.params import RenderParams as JParams
    from neural_renderer_tpu.render.pathtrace import render_gt_frame as jgt
    from neural_renderer_tpu.scene.envmap import EnvironmentMap
    from neural_renderer_tpu.scene.scene import Scene as JScene
    from neural_renderer_tpu_torch.render.params import RenderParams
    from neural_renderer_tpu_torch.render.pathtrace import render_gt_frame
    from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
    from neural_renderer_tpu_torch.scene.materials import Material

    cfg = load_config(os.path.join(ROOT, "configs", "sphere", "sphere.json"))
    scene = JScene.from_config(cfg, sphere_fallback=False)
    a = scene.original_mesh.to_arrays()
    assert a.num_triangles == 9216
    w, h = 32, 24
    cam = dict(cam_pos=[0.3, 0.2, 3.0], cam_forward=[0.0, 0.0, -1.0],
               cam_right=[1.0, 0.0, 0.0], cam_up=[0.0, 1.0, 0.0], fov_y=0.8)
    with jax.disable_jit():
        jp = JParams.make(width=w, height=h, samples_per_pixel=1,
                          max_bounces=2, material=scene.global_material,
                          scene_scale=2.0, **cam)
        ref, ref_accum = jgt(a, EnvironmentMap().to_arrays(), jp,
                             jnp.zeros((3, w * h), jnp.float32))
    gm = scene.global_material
    mat = Material(base_color=tuple(gm.base_color.value),
                   metallic=gm.metallic.value, roughness=gm.roughness.value,
                   specular=gm.specular.value,
                   clearcoat_gloss=gm.clearcoat_gloss.value)
    np.testing.assert_array_equal(mat.scalar_row(),
                                  np.asarray(jp.material_row))
    p = RenderParams.make(width=w, height=h, samples_per_pixel=1,
                          max_bounces=2, material=mat, scene_scale=2.0,
                          device="cpu", **cam)
    img, accum = render_gt_frame(
        carry(a), EnvironmentTensors.from_numpy(None, device="cpu"), p,
        torch.zeros((3, w * h)))
    _image_close(img.numpy(), np.asarray(ref))
    assert (np.asarray(ref) != np.asarray(ref)[0, 0]).any()
