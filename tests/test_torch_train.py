"""The port's training path against the JAX package's, on the CPU.

The JAX side runs op by op (`jax.disable_jit()`), never in Pallas interpret
mode, so it rounds like the port and compiles nothing. Inputs come from
numpy or from JAX's own key-derived rays, handed to both sides.

Tolerances (each stated at its test):
- losses: every component to 1e-6 relative;
- sampler: `valid` and `presence` agree on >= 99.9% of rows; inputs,
  distance, normal and color within 1e-5 where both rows are valid (and
  agree on presence, for the supervision);
- AdamW against optax.adamw over 5 steps: parameters to 1e-6 relative;
- training forward against `nbvh.apply(bf16)`: 1e-5 x max|output| on at
  least 95% of rays and 2e-2 (K2's bound) on all: the two sum a layer's
  bf16 products in f32 in different orders, and where that flips the bf16
  rounding of one of a ray's 512 hidden activations its outputs move by
  ~1e-3 x max (4 rays of 256 here); the twin's parameter gradients against JAX autodiff of `nbvh.apply(bf16)`:
  within 2e-2 of each parameter's largest |grad| (the JAX package's own
  kernel-against-twin bound, tests/test_lane_grid.py);
- the first train-step loss against JAX `loss_fn`: 1e-5 relative.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.train import dataset as jds
from neural_renderer_tpu.train import losses as jlosses
from neural_renderer_tpu.train import trainer as jtrainer

from util import outward_sphere, two_lobe_sphere

from neural_renderer_tpu_torch.cli import train as train_cli
from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.ops import lane_grid_kernel, traversal
from neural_renderer_tpu_torch.ops.lane_grid_train_kernel import (
    apply_train, backward_twin)
from neural_renderer_tpu_torch.render.renderer import Renderer
from neural_renderer_tpu_torch.scene.mesh import outward_sphere as t_sphere
from neural_renderer_tpu_torch.scene.scene import Scene
from neural_renderer_tpu_torch.train import (
    SegmentBatch, TrainConfig, dataset, init_train_state, losses,
    make_optimizer, make_train_step, make_train_step_on_batch,
    segment_domain)
from neural_renderer_tpu_torch.train.trainer import loss_fn

# One intra-op thread: the suite runs several pytest workers side by side.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def carry(a):
    """A JAX MeshArrays as the port's MeshTensors, same triangle order."""
    n = np.asarray
    return convert.mesh_from_numpy(
        n(a.tris_packed), a.num_triangles, device="cpu",
        vertices=n(a.vertices), normals=n(a.normals), uvs=n(a.uvs),
        indices=n(a.indices), tri_material=n(a.tri_material),
        nodes_packed=n(a.nodes_packed), mat_scalars=n(a.mat_scalars),
        has_normals=a.has_normals, has_uvs=a.has_uvs,
        has_materials=a.has_materials, max_leaf=a.max_leaf)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def test_shell_losses_match_jax():
    """Each loss component equals JAX's to 1e-6 relative."""
    r = np.random.default_rng(0)
    b = 700
    out = r.normal(size=(16, b)).astype(np.float32)
    valid = r.uniform(size=b) < 0.8
    presence = ((r.uniform(size=b) < 0.5) & valid).astype(np.float32)
    normal = r.normal(size=(3, b))
    normal = (normal / np.linalg.norm(normal, axis=0)).astype(np.float32)
    fields = dict(inputs=r.uniform(size=(12, b)).astype(np.float32),
                  presence=presence,
                  distance=r.uniform(size=b).astype(np.float32),
                  normal=normal,
                  color=r.uniform(size=(3, b)).astype(np.float32),
                  valid=valid)
    with jax.disable_jit():
        _, ref = jlosses.shell_losses(
            jnp.asarray(out), jds.SegmentBatch(
                **{k: jnp.asarray(v) for k, v in fields.items()}))
    _, got = losses.shell_losses(torch.as_tensor(out), SegmentBatch(
        **{k: torch.as_tensor(v) for k, v in fields.items()}))
    assert set(got) == set(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) < 1e-6, (k, float(got[k]), float(ref[k]))


def _jax_rays(key, rays, radius, omin, inv):
    """The JAX sampler's rays, drawn as train/dataset.py draws them."""
    k1, k2 = jax.random.split(key)
    o = jax.random.normal(k1, (3, rays), jnp.float32)
    o = o / jnp.linalg.norm(o, axis=0, keepdims=True) * radius
    u = jax.random.uniform(k2, (3, rays), jnp.float32)
    target = omin[:, None] + u / jnp.maximum(inv[:, None], 1e-12)
    d = target - o
    d = d / jnp.linalg.norm(d, axis=0, keepdims=True)
    return np.asarray(o), np.asarray(d)


@pytest.fixture(scope="module")
def lobes():
    """Two disjoint lobes (tests/util.py): a non-convex closed surface, so
    rays through both re-enter the outer shell."""
    a = [m.to_arrays() for m in (two_lobe_sphere(1.0, 1.5),
                                 two_lobe_sphere(1.2, 1.5),
                                 two_lobe_sphere(0.8, 1.5))]
    return (a, [carry(m) for m in a], np.asarray([-2.7, -1.2, -1.2],
                                                 np.float32),
            np.asarray([1 / 5.4, 1 / 2.4, 1 / 2.4], np.float32), 4.5)


@pytest.mark.parametrize("sweep", [True, False])
@pytest.mark.parametrize("s", [1, 3])
def test_sampler_matches_jax(lobes, s, sweep):
    """JAX's rays through segment_batch_from_rays against JAX
    sample_segment_batch on the same key (512 rays): valid and presence
    agree on >= 99.9% of rows, inputs within 1e-5 where both rows are valid,
    and distance, normal and color within 1e-5 where both are present."""
    (jgt, jout, jin), (tgt, tout, tin), omin, inv, radius = lobes
    batch = 512 * s
    key = jax.random.PRNGKey(7)
    with jax.disable_jit():
        ref = jds.sample_segment_batch(
            key, jgt, jout, jin, jnp.asarray(omin), jnp.asarray(inv), batch,
            radius, s, sweep=sweep)
        o, d = _jax_rays(key, 512, radius, jnp.asarray(omin),
                         jnp.asarray(inv))
    got = dataset.segment_batch_from_rays(
        torch.from_numpy(o.copy()), torch.from_numpy(d.copy()), tgt, tout,
        tin, torch.as_tensor(omin), torch.as_tensor(inv), batch, s,
        sweep=sweep)
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}
    assert got["inputs"].shape == ref["inputs"].shape == (12, batch)
    assert np.mean(got["valid"] == ref["valid"]) >= 0.999
    both = got["valid"] & ref["valid"]
    assert both.sum() > 120
    assert np.mean(got["presence"][both] == ref["presence"][both]) >= 0.999
    assert np.abs(got["inputs"] - ref["inputs"])[:, both].max() <= 1e-5
    pres = both & (got["presence"] > 0) & (ref["presence"] > 0)
    assert pres.sum() > 50
    for k in ("distance", "normal", "color"):
        assert np.abs(got[k] - ref[k])[..., pres].max() <= 1e-5, k
    if s == 3:  # the re-entry rows (second segments) are live
        assert both[512:1024].sum() > 10


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_matches_optax(schedule):
    """make_optimizer against optax.adamw (with its cosine schedule) over 5
    steps on the same params and grads: params to 1e-6 relative."""
    cfg = TrainConfig(learning_rate=3e-3, weight_decay=1e-2, steps=4,
                      lr_schedule=schedule, lr_end_factor=0.1)
    r = np.random.default_rng(1)
    shapes = [(3, 2, 4, 2, 128), (64, 112), (16, 64)]
    p0 = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(r.normal(size=s) * 10.0 ** r.integers(-3, 1)).astype(
        np.float32) for s in shapes] for _ in range(5)]

    tp = [torch.nn.Parameter(torch.as_tensor(a.copy())) for a in p0]
    opt, sched = make_optimizer(cfg, tp)
    jopt = jtrainer.make_optimizer(jtrainer.TrainConfig(
        learning_rate=3e-3, weight_decay=1e-2, steps=4,
        lr_schedule=schedule, lr_end_factor=0.1))
    jp = [jnp.asarray(a) for a in p0]

    @jax.jit  # one compile instead of an eager compile per operation
    def jstep(g, jstate, jp):
        upd, jstate = jopt.update(g, jstate, jp)
        return jstate, optax.apply_updates(jp, upd)

    jstate = jopt.init(jp)
    for g in grads:
        for p, gi in zip(tp, g):
            p.grad = torch.as_tensor(gi)
        opt.step()
        sched.step()
        jstate, jp = jstep([jnp.asarray(x) for x in g], jstate, jp)
    for p, q in zip(tp, jp):
        a, b = p.detach().numpy(), np.asarray(q)
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def _small_net():
    """The JAX package's small config of its kernel-against-twin test
    (tests/test_lane_grid.py), with seeded numpy weights given to both
    sides; tables scaled to non-trivial values."""
    jcfg = jnbvh.NbvhConfig(grid_type="lane", lane_sublanes=4,
                            lane_entry_pack=2, log2_hashmap_size=10,
                            base_resolution=8)
    r = np.random.default_rng(5)
    dims = [jcfg.encoded_dims, 128, 128, 128, 128, 16]
    params = {"lane": r.uniform(-0.1, 0.1, size=(3, 8, 4, 4, 2, 128))
              .astype(np.float32),
              "mlp": [(r.normal(size=(dims[i + 1], dims[i]))
                       * np.sqrt(2.0 / dims[i])).astype(np.float32)
                      for i in range(5)]}
    net = convert.params_from_numpy(
        params, nbvh.NbvhConfig(lane_sublanes=4, lane_entry_pack=2,
                                log2_hashmap_size=10, base_resolution=8),
        device="cpu")
    return jcfg, {"lane": jnp.asarray(params["lane"]),
                  "mlp": [jnp.asarray(w) for w in params["mlp"]]}, net


def test_train_forward_and_twin_grads_match_jax():
    """apply_train's forward (the training-layout twin) against JAX
    nbvh.apply(bf16): 1e-5 x max on >= 95% of rays, 2e-2 x max on all (see
    the module docstring); its gradients (backward_twin through
    the autograd Function) against JAX autodiff of nbvh.apply(bf16), each
    parameter within 2e-2 of its largest |grad|; the input cotangent is
    zeros."""
    jcfg, params, net = _small_net()
    r = np.random.default_rng(2)
    x = r.uniform(size=(12, 256)).astype(np.float32)
    tgt = r.normal(size=(16, 256)).astype(np.float32)
    def loss_twin(p):
        out = jnbvh.apply(p, jnp.asarray(x), jcfg, compute_dtype=jnp.bfloat16)
        return jnp.sum((out - jnp.asarray(tgt)) ** 2), out

    with jax.disable_jit():
        (_, out_j), grads_j = jax.value_and_grad(loss_twin, has_aux=True)(
            params)
    out_j = np.asarray(out_j)

    net.requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    out = apply_train(net, xt)
    assert out.shape == (16, 256)
    diff = np.abs(out.detach().numpy() - out_j)
    top = np.abs(out_j).max()
    flipped = (diff > 1e-5 * top).any(axis=0).mean()
    assert flipped <= 0.05, flipped
    assert diff.max() <= 2e-2 * top
    ((out - torch.as_tensor(tgt)) ** 2).sum().backward()
    assert torch.equal(xt.grad, torch.zeros_like(xt))
    pairs = [(net.lane.grad, grads_j["lane"])] + [
        (w.grad, gj) for w, gj in zip(net.mlp, grads_j["mlp"])]
    for got, ref in pairs:
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 2e-2 * np.abs(ref).max()
    # The Function's gradients are backward_twin's, exactly.
    g = 2.0 * (out.detach() - torch.as_tensor(tgt))
    d_lane, dws = backward_twin(net, torch.as_tensor(x), g)
    assert torch.equal(d_lane, net.lane.grad)
    for a, w in zip(dws, net.mlp):
        assert torch.equal(a, w.grad)


def test_trace_presorted_equals_sorted():
    """trace_mesh(presorted=True) on rays already in _ray_sort_order equals
    presorted=False on the clustered branch (4,480 triangles)."""
    mesh = t_sphere(36, 64, 1.0).to_tensors("cpu")
    assert mesh.num_triangles > traversal._CLUSTERED_TRACE_MIN_TRIS
    r = np.random.default_rng(3)
    n = 1000
    o = r.normal(size=(3, n))
    o = torch.as_tensor((3.0 * o / np.linalg.norm(o, axis=0))
                        .astype(np.float32))
    d = torch.as_tensor(r.uniform(-1.0, 1.0, size=(3, n))
                        .astype(np.float32)) - o
    d = d / torch.linalg.vector_norm(d, dim=0, keepdim=True)
    active = torch.as_tensor(r.uniform(size=n) < 0.9)
    order = traversal._ray_sort_order(o, d, None)
    o, d, active = o[:, order], d[:, order], active[order]
    for mode in (traversal.ANY, traversal.FORWARD_ONLY):
        a = traversal.trace_mesh(mesh, o, d, mode, active=active,
                                 presorted=True)
        b = traversal.trace_mesh(mesh, o, d, mode, active=active)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert a.hit.sum() > 150


def _to_jax_batch(batch):
    return jds.SegmentBatch(**{k: jnp.asarray(v.numpy())
                               for k, v in batch._asdict().items()})


def test_train_step_lowers_loss_and_first_loss_matches_jax():
    """Eight CPU steps through apply_train (the kernels' twins) lower the
    loss; the first loss equals JAX loss_fn on the same params and batch to
    1e-5 relative."""
    scene = Scene(original_mesh=t_sphere(8, 16, 1.0),
                  inner_shell=t_sphere(8, 16, 0.8),
                  outer_shell=t_sphere(8, 16, 1.2))
    jcfg, _, _ = _small_net()
    cfg = nbvh.NbvhConfig(lane_sublanes=4, log2_hashmap_size=10,
                          base_resolution=8)
    tcfg = TrainConfig(batch_size=256, steps=8, learning_rate=3e-3)
    omin, inv, radius = segment_domain(scene, "cpu")
    meshes = [scene.original_mesh.to_tensors("cpu"),
              scene.outer_shell.to_tensors("cpu"),
              scene.inner_shell.to_tensors("cpu")]
    state = init_train_state(tcfg, cfg, "cpu")
    gen = torch.Generator().manual_seed(3)
    batch = dataset.sample_segment_batch(gen, *meshes, omin, inv, 256,
                                         radius)
    params_j = {k: jnp.asarray(v) if k == "lane" else
                [jnp.asarray(w) for w in v]
                for k, v in convert.params_to_numpy(state.net).items()}
    with jax.disable_jit():
        ref, _ = jtrainer.loss_fn(params_j, _to_jax_batch(batch), jcfg,
                                  jnp.bfloat16)
    ops0 = lane_grid_kernel._operands(state.net, train=True)
    _, m = make_train_step_on_batch(tcfg, cfg, "cpu")(state, batch)
    losses_seen = [float(m["total"])]
    # The kernels' operand cache repacks after the optimizer's step: new
    # bf16 weights, and the training-layout tables a view of the masters.
    ops1 = lane_grid_kernel._operands(state.net, train=True)
    assert ops1 is not ops0 and ops1.sublanes == 8
    assert torch.equal(ops1.w_out, state.net.mlp[4].detach()
                       .to(torch.bfloat16).t())
    assert ops1.tables2d.data_ptr() == state.net.lane.data_ptr()
    assert _rel(losses_seen[0], ref) < 1e-5, (losses_seen[0], float(ref))
    step = make_train_step(tcfg, cfg, *meshes, omin, inv, radius,
                           device="cpu")
    for _ in range(7):
        _, m = step(state, gen)
        losses_seen.append(float(m["total"]))
    assert state.step == 8
    assert np.isfinite(losses_seen).all()
    assert losses_seen[-1] < losses_seen[0]
    # The unfused path (autograd through the plain forward) gives the same
    # loss on the same batch.
    assert _rel(loss_fn(state.net, batch, fused=False)[0],
                loss_fn(state.net, batch, fused=True)[0]) < 1e-6


def _write_obj(path, mesh):
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {float(v[0])!r} {float(v[1])!r} {float(v[2])!r}\n")
        for t in mesh.indices:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def _tiny_config(tmp_path, grid_type="lane"):
    with open(os.path.join(ROOT, "configs", "sphere", "sphere_lane.json")) \
            as f:
        j = json.load(f)
    for key, r in (("original_mesh", 1.0), ("inner_shell", 0.8),
                   ("outer_shell", 1.2)):
        _write_obj(tmp_path / f"{key}.obj", t_sphere(8, 16, r))
        j["scene"][key]["path"] = f"{key}.obj"
    j["neural_network"].update(grid_type=grid_type, lane_sublanes=2)
    j["checkpoint_path"] = "tiny_ckpt/step_2"
    path = tmp_path / f"tiny_{grid_type}.json"
    with open(path, "w") as f:
        json.dump(j, f)
    return str(path)


def test_train_cli_cpu(tmp_path, capsys):
    """train.main on the CPU: the checkpoint loads in the Renderer (through
    the config's checkpoint_path) with equal tensors, --resume continues
    the step count, and --dp, a tcnn config and an orbax directory are
    refused by name."""
    cfg = _tiny_config(tmp_path)
    ckpt = str(tmp_path / "tiny_ckpt")
    common = [cfg, "--batch-size", "192", "--segments-per-ray", "3",
              "--lr-schedule", "cosine", "--log-every", "1", "--device",
              "cpu", "--ckpt-dir", ckpt]
    assert train_cli.main(common + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "step 2/2 loss=" in out and "Msegments/s" in out
    weights = str(tmp_path / "tiny_step2.npz")
    assert f"final checkpoint: {weights}" in out

    from neural_renderer_tpu_torch.config import load_config
    lcfg = load_config(cfg)
    rend = Renderer(Scene(), lcfg.neural_network, device="cpu")
    assert rend.load_weights_from_file(lcfg.checkpoint_path)
    saved = convert.load_params_npz(weights)
    assert np.array_equal(rend.net.lane.numpy(), saved["lane"])
    for w, s in zip(rend.net.mlp, saved["mlp"]):
        assert np.array_equal(w.numpy(), s)

    assert train_cli.main(common + ["--steps", "3", "--resume",
                                    weights]) == 0
    out = capsys.readouterr().out
    assert "from step 2" in out and "step 3/3" in out \
        and "step 1/3" not in out
    assert os.path.exists(tmp_path / "tiny_step3.adam.npz")

    assert train_cli.main([cfg, "--dp", "2", "--device", "cpu"]) == 1
    assert "--dp/--tp" in capsys.readouterr().err
    assert train_cli.main([_tiny_config(tmp_path, "tcnn"), "--device",
                           "cpu"]) == 1
    assert "tcnn" in capsys.readouterr().err
    orbax_dir = os.path.join(ROOT, "configs", "sphere", "lane16_ckpt",
                             "step_24000")
    assert train_cli.main([cfg, "--resume", orbax_dir, "--device",
                           "cpu"]) == 1
    assert "export_lane_ckpt_npz" in capsys.readouterr().err
