"""The port's tcnn-layout network against the JAX package's, on the CPU.

Covers the hash-grid encode, the flat FP16 blob IO, the fused MLP's twin
(ops/fused_network.py), the reference-format sphere scene's neural frame
and one tcnn training step. Inputs come from numpy seeds and
configs/sphere/weights.bin, handed to both sides. The JAX side runs op by
op (`jax.disable_jit()`) where a jit compile would dominate; the JAX fused
kernel runs in Pallas interpret mode, as its own tests run it.

Tolerances (each stated at its test):
- hash-grid encode: exact (the same f32 ops in the same order, corners
  added in dz, dy, dx order; uint32 hashing emulated in int64);
- blob: array for array exact, and a save round trip byte-identical;
- fused MLP twin against JAX `apply_fused(interpret=True)` and
  `nbvh.apply(bf16)`: 1e-3 of the largest output (they sum a layer's bf16
  products in different orders, so a hidden activation may round to a
  neighbouring bf16 value);
- the 32x24, 2-bounce sphere.json neural frame: tests/test_golden.py's
  cross-backend tolerance, max u8 difference <= 2 and < 5% of pixels
  differing;
- one training step: loss to 1e-4 relative; gradients within 2e-2 of each
  parameter's largest |grad|, since XLA and autograd round the cotangents
  of the bf16 casts in different places.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.models import encoding as jenc
from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.ops import fused_network as jfused
from neural_renderer_tpu.train import dataset as jds
from neural_renderer_tpu.train import losses as jlosses

from neural_renderer_tpu_torch.config import load_config
from neural_renderer_tpu_torch.models import convert, encoding, nbvh
from neural_renderer_tpu_torch.ops import fused_network
from neural_renderer_tpu_torch.render.renderer import Renderer
from neural_renderer_tpu_torch.scene.scene import Scene
from neural_renderer_tpu_torch.train import (SegmentBatch, TrainConfig,
                                             make_optimizer,
                                             make_train_step_on_batch,
                                             restore_checkpoint,
                                             save_checkpoint)
from neural_renderer_tpu_torch.train.trainer import TrainState

# One intra-op thread: the suite runs several pytest workers side by side.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPHERE = os.path.join(ROOT, "configs", "sphere")
BLOB = os.path.join(SPHERE, "weights.bin")
TCNN = nbvh.NbvhConfig(grid_type="tcnn")


@pytest.fixture(scope="module")
def jparams():
    return jnbvh.load_flat_blob(BLOB, jnbvh.NbvhConfig())


def _points(n, seed):
    """[3, n] points in [0, 1] with both wrap edges: x a hair below 0 (the
    level-0 corner at -1) and x at 1 (the dense corner at res)."""
    x = np.random.default_rng(seed).uniform(size=(3, n)).astype(np.float32)
    x[0, :40] = -np.linspace(1e-3, 0.15, 40, dtype=np.float32)
    x[1, 20:60] = 1.0
    x[2, 50:70] = np.float32(1.0) - np.float32(1e-7)
    x[:, 70:80] = 0.0
    return x


@pytest.mark.parametrize("cfg", [
    jenc.HashGridConfig(),   # the sphere's: level 0 dense, 1-7 hashed
    jenc.HashGridConfig(n_levels=6, log2_hashmap_size=12, base_resolution=5,
                        per_level_scale=1.5)], ids=["sphere", "dense3"])
def test_hashgrid_encode_equals_jax(cfg):
    """hashgrid_encode on seeded points and tables, dense and hashed
    levels (the second config has dense levels of 125, 512 and 1,728
    entries, the first padded to 128), equals JAX exactly."""
    pcfg = encoding.HashGridConfig(**cfg.__dict__)
    for lv in range(cfg.n_levels):
        assert pcfg.level_entries(lv) == cfg.level_entries(lv)
        assert pcfg.level_is_dense(lv) == cfg.level_is_dense(lv)
    assert pcfg.n_params == cfg.n_params
    dense = [pcfg.level_is_dense(lv) for lv in range(cfg.n_levels)]
    assert any(dense) and not all(dense)
    r = np.random.default_rng(1)
    tables = [r.uniform(-1, 1, size=(cfg.level_entries(lv), 4))
              .astype(np.float32) for lv in range(cfg.n_levels)]
    x = _points(768, 0)
    with jax.disable_jit():
        ref = np.asarray(jenc.hashgrid_encode([jnp.asarray(t)
                                               for t in tables],
                                              jnp.asarray(x), cfg))
    got = encoding.hashgrid_encode([torch.as_tensor(t) for t in tables],
                                   torch.as_tensor(x), pcfg).numpy()
    np.testing.assert_array_equal(got, ref)
    # The wrap edges reach negative corners and corners at res.
    c0 = np.floor(x * np.float32(pcfg.level_scale(0)) + np.float32(0.5))
    assert c0.min() < 0 and c0.max() == pcfg.level_resolution(0) - 1


def test_corner_index_wraps_as_uint32():
    """_corner_index equals numpy's wrapping uint32 arithmetic on corners
    across the whole int32 range (the int64 products never overflow)."""
    cfg = encoding.HashGridConfig()
    r = np.random.default_rng(5)
    c = r.integers(-2**31, 2**31, size=(3, 5000), dtype=np.int64)
    c[:, :3] = [[-1, 2**31 - 1, 0], [-1, -2**31, 17], [-1, 5, -2]]
    u = c.astype(np.uint32)
    for level in (0, 3):
        entries = np.uint32(cfg.level_entries(level))
        with np.errstate(over="ignore"):
            if cfg.level_is_dense(level):
                res = np.uint32(cfg.level_resolution(level))
                want = u[0] + u[1] * res + u[2] * (res * res)
            else:
                want = (u[0] * np.uint32(1) ^ u[1] * np.uint32(2654435761)
                        ^ u[2] * np.uint32(805459861))
        got = encoding._corner_index(cfg, level, *torch.as_tensor(c))
        np.testing.assert_array_equal(got.numpy(), want % entries)


def test_flat_blob_equals_jax_and_round_trips(jparams, tmp_path):
    """load_flat_blob(weights.bin) equals the JAX load array for array;
    save_flat_blob writes the file's bytes back; the Renderer loads the
    blob for a tcnn config and refuses it for a lane config with the JAX
    package's message."""
    net = nbvh.load_flat_blob(BLOB, TCNN, device="cpu")
    assert len(jparams["grids"]) == 1
    for got, ref in zip(list(net.grid) + list(net.mlp),
                        jparams["grids"][0] + jparams["mlp"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert sum(p.numel() for p in net.parameters()) == \
        TCNN.hg_n_params + TCNN.mlp_n_params == 540672
    out = str(tmp_path / "w.bin")
    nbvh.save_flat_blob(out, net)
    with open(out, "rb") as f, open(BLOB, "rb") as g:
        assert f.read() == g.read()

    cfg = load_config(os.path.join(SPHERE, "sphere.json"))
    rend = Renderer(Scene(), cfg.neural_network, device="cpu")
    assert rend.load_weights_from_file(cfg.checkpoint_path)
    assert torch.equal(rend.net.mlp[4], net.mlp[4])
    lane_cfg = load_config(os.path.join(SPHERE, "sphere_lane.json"))
    lane = Renderer(Scene(), lane_cfg.neural_network, device="cpu")
    assert not lane.load_weights_from_file(BLOB)
    # .npz checkpoints keep the tcnn layout, the grid as grid_<l> keys; a
    # pytree of one grid per encoder slot is refused.
    npz = convert.save_params_npz(str(tmp_path / "w.npz"), net)
    with np.load(npz) as z:
        assert sorted(z.files)[:2] == ["grid_0", "grid_1"]
    back = convert.params_from_numpy(convert.load_params_npz(npz), TCNN,
                                     device="cpu")
    for a, b in zip(back.parameters(), net.parameters()):
        assert torch.equal(a, b)
    three = convert.params_to_numpy(net)
    three["grids"] *= 3
    with pytest.raises(ValueError, match="3 hash grids"):
        convert.params_from_numpy(three, TCNN, device="cpu")


def test_fused_twin_matches_jax(jparams):
    """The port's apply_fused on CPU tensors (encode + the K7 twin) against
    JAX apply_fused(interpret=True) and nbvh.apply(bf16) on 768 seeded
    rays with the shipped weights: within 1e-3 of the largest output. The
    twin on encode_inputs' [N, 112] f32 rows (fused_mlp's contract) equals
    the port's own bf16 forward exactly, and nbvh.apply in ENC_CHUNK
    chunks equals one pass. 768 rays and op-by-op JAX, as in the
    encode test and the 32x24 frame test, let the three share the compiled
    JAX primitives."""
    r = np.random.default_rng(3)
    x = r.uniform(size=(12, 768)).astype(np.float32)
    jcfg = jnbvh.NbvhConfig()
    with jax.disable_jit():
        ref_k = np.asarray(jfused.apply_fused(jparams, jnp.asarray(x), jcfg,
                                              interpret=True))
        ref_x = np.asarray(jnbvh.apply(jparams, jnp.asarray(x), jcfg,
                                       compute_dtype=jnp.bfloat16))
    net = nbvh.load_flat_blob(BLOB, TCNN, device="cpu")
    xt = torch.as_tensor(x)
    got = fused_network.apply_fused(net, xt).numpy()
    assert got.shape == (16, 768)
    top = np.abs(ref_k).max()
    for ref in (ref_k, ref_x):
        d = np.abs(got - ref)
        print(f"max |port - JAX| / max {d.max() / top:.3e}, rays beyond "
              f"1e-5 x max {(d > 1e-5 * top).any(axis=0).mean():.4f}")
        assert d.max() <= 1e-3 * top
    enc = nbvh.encode_inputs(net, xt)
    assert enc.dtype == torch.float32 and enc.shape == (768, 112)
    twin = fused_network.apply_fused_twin(net, enc)
    assert torch.equal(twin, nbvh.mlp_forward(list(net.mlp), enc))
    assert torch.equal(fused_network.fused_mlp(net, enc), twin)
    assert np.array_equal(twin.numpy(), got)
    saved = nbvh.ENC_CHUNK
    try:
        nbvh.ENC_CHUNK = 256
        chunked = nbvh.apply(net, xt)
    finally:
        nbvh.ENC_CHUNK = saved
    assert torch.equal(chunked, twin)


def test_sphere_json_frame_matches_jax(jparams):
    """A 32x24, 2-bounce neural frame of configs/sphere/sphere.json (its
    shells, material and weights.bin) against the JAX frame op by op."""
    from neural_renderer_tpu.config import load_config as jload_config
    from neural_renderer_tpu.render.neural_frame import \
        render_neural_frame as jframe
    from neural_renderer_tpu.render.neural_march import NeuralContext as JCtx
    from neural_renderer_tpu.render.params import RenderParams as JParams
    from neural_renderer_tpu.scene.envmap import EnvironmentMap
    from neural_renderer_tpu.scene.mesh import Mesh
    from neural_renderer_tpu.scene.scene import Scene as JScene
    from neural_renderer_tpu_torch.render import neural_frame, neural_march
    from neural_renderer_tpu_torch.render.params import RenderParams
    from neural_renderer_tpu_torch.scene.envmap import EnvironmentTensors
    from neural_renderer_tpu_torch.scene.materials import Material

    jscene = JScene.from_config(jload_config(os.path.join(SPHERE,
                                                          "sphere.json")),
                                sphere_fallback=False)
    oa = jscene.outer_shell.to_arrays()
    ia = jscene.inner_shell.to_arrays()
    omin, omax = jscene.outer_shell.bounds()
    w, h = 32, 24
    cam = dict(cam_pos=[0.0, 0.0, 3.0], cam_forward=[0.0, 0.0, -1.0],
               cam_right=[1.0, 0.0, 0.0], cam_up=[0.0, 1.0, 0.0], fov_y=0.9,
               scene_scale=2.0, outer_shell_min=omin,
               outer_shell_inv_extent=1.0 / (omax - omin))
    gm = jscene.global_material
    with jax.disable_jit():
        jp = JParams.make(w, h, 1, 2, material=gm, **cam)
        ref, _ = jframe(JCtx(outer=oa, inner=ia, net_params=jparams,
                             config=jnbvh.NbvhConfig()),
                        Mesh().to_arrays(), EnvironmentMap().to_arrays(), jp,
                        jnp.zeros((3, w * h), jnp.float32))
        ref = np.asarray(ref)
    mat = Material(base_color=tuple(gm.base_color.value),
                   metallic=gm.metallic.value, roughness=gm.roughness.value,
                   specular=gm.specular.value,
                   clearcoat_gloss=gm.clearcoat_gloss.value)
    meshes = [convert.mesh_from_numpy(np.asarray(a.tris_packed),
                                      a.num_triangles, device="cpu")
              for a in (oa, ia)]
    ctx = neural_march.NeuralContext(
        meshes[0], meshes[1], nbvh.load_flat_blob(BLOB, TCNN, device="cpu"))
    img, accum = neural_frame.render_neural_frame(
        ctx, EnvironmentTensors.from_numpy(None, device="cpu"),
        RenderParams.make(w, h, 1, 2, material=mat, device="cpu", **cam),
        torch.zeros((3, w * h)))
    assert img.dtype == torch.uint8 and tuple(img.shape) == (h, w, 3)
    assert torch.isfinite(accum).all()
    diff = np.abs(img.numpy().astype(int) - ref.astype(int))
    print(f"max u8 difference {diff.max()}, share of pixels differing "
          f"{(diff.sum(axis=-1) > 0).mean():.4f}")
    assert diff.max() <= 2
    assert (diff.sum(axis=-1) > 0).mean() < 0.05
    assert (ref != ref[0, 0]).any()


def _batch(n, seed):
    r = np.random.default_rng(seed)
    nrm = r.normal(size=(3, n))
    return dict(
        inputs=r.uniform(0.02, 0.98, size=(12, n)),
        presence=(r.uniform(size=n) < 0.5).astype(np.float32),
        distance=r.uniform(0.0, 0.5, size=n),
        normal=nrm / np.linalg.norm(nrm, axis=0),
        color=r.uniform(size=(3, n)),
        valid=r.uniform(size=n) < 0.9)


def test_train_step_matches_jax_grad(tmp_path):
    """One tcnn training step (autograd through the hash-grid encode and
    nbvh.mlp_forward) on one seeded batch of 512 segments, for a seeded
    two-level network (a dense and a hashed level, one shared grid): its
    loss against the JAX loss (nbvh.apply(bf16) -> shell_losses) to 1e-4
    relative, every
    gradient within 2e-2 of the JAX gradient's largest |grad| (see the
    module docstring). The JAX gradient is jitted: op by op, compiling each
    primitive took 17 s against 4 s for the whole graph, and the tolerances
    need no exact rounding. The checkpoint of the updated state restores
    with equal tensors and Adam moments."""
    kw = dict(n_levels=2, log2_hashmap_size=11, base_resolution=8)
    jcfg = jnbvh.NbvhConfig(grid_type="tcnn", **kw)
    cfg = nbvh.NbvhConfig(grid_type="tcnn", **kw)
    assert cfg.grid.level_is_dense(0) and not cfg.grid.level_is_dense(1)
    r = np.random.default_rng(4)
    params = {
        "grids": [[r.uniform(-0.1, 0.1, size=(cfg.grid.level_entries(lv),
                                               4)).astype(np.float32)
                   for lv in range(2)]],
        "mlp": [(r.normal(size=(o, i)) * np.sqrt(2.0 / i)).astype(np.float32)
                for i, o in zip(cfg.mlp_dims[:-1], cfg.mlp_dims[1:])]}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    arrays = _batch(512, 9)
    jb = jds.SegmentBatch(**{k: jnp.asarray(v if k == "valid" else
                                            v.astype(np.float32))
                             for k, v in arrays.items()})

    def loss(p):
        out = jnbvh.apply(p, jb.inputs, jcfg, compute_dtype=jnp.bfloat16)
        return jlosses.shell_losses(out, jb)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss))(jparams)

    net = convert.params_from_numpy(params, cfg, device="cpu")
    net.requires_grad_(True)
    tcfg = TrainConfig(batch_size=512, steps=1)
    opt, sched = make_optimizer(tcfg, net.parameters())
    state = TrainState(net, opt, sched, 0)
    batch = SegmentBatch(**{k: torch.as_tensor(v if k == "valid" else
                                               v.astype(np.float32))
                            for k, v in arrays.items()})
    _, m = make_train_step_on_batch(tcfg, cfg, "cpu")(state, batch)
    rel = abs(float(m["total"]) - float(ref_loss)) / float(ref_loss)
    print(f"loss {float(m['total'])!r} vs JAX {float(ref_loss)!r}, "
          f"relative {rel:.3e}")
    assert rel < 1e-4
    worst = 0.0
    for p, g in zip(list(net.grid) + list(net.mlp),
                    ref_grads["grids"][0] + ref_grads["mlp"]):
        g = np.asarray(g, np.float32)
        assert p.grad.shape == g.shape
        worst = max(worst, np.abs(p.grad.numpy() - g).max()
                    / np.abs(g).max())
    print(f"largest gradient difference / max|JAX grad| {worst:.3e}")
    assert worst <= 2e-2
    assert state.step == 1

    weights = save_checkpoint(str(tmp_path / "t_ckpt"), state)
    back = restore_checkpoint(weights, tcfg, cfg, "cpu")
    assert back.step == 1
    for a, b in zip(back.net.parameters(), net.parameters()):
        assert torch.equal(a, b)
        assert torch.equal(back.optimizer.state[a]["exp_avg"],
                           opt.state[b]["exp_avg"])
