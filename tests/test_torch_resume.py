"""Resuming the JAX package's orbax checkpoints in the port, on the CPU.

scripts/export_lane_ckpt_npz.py writes, beside the weights `.npz`, the
optimizer state `.adam.npz` (optax's mu, nu as AdamW's exp_avg,
exp_avg_sq, and the step, equal to optax's counts); the committed
configs/knot/lane_step48000.adam.npz is its export of the shipped knot
checkpoint. The port's `restore_checkpoint` of that pair, then one step on
a batch the port's sampler draws from the knot scene (1,536 segments, 3 a
ray, seeded), against the JAX trainer's step from its orbax restore on
the same batch (cosine schedule over 48,010 steps, the JAX side under
`jax.disable_jit()`; orbax is used on the JAX side only). Tolerances:
the losses to 1e-5 relative (tests/test_torch_train.py's); the step's
change of the first moment (0.1 x the gradient) within 2e-2 of its
largest value (the gradient bound there); the parameters' update within
2e-2 of the largest update on the entries whose second moment exceeds
1e-3 of its largest (where the checkpoint's history makes Adam's update
smooth in the gradient; a table entry the history barely touched moves by
about the learning rate times the sign of a small gradient).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.train import dataset as jds
from neural_renderer_tpu.train import trainer as jtrainer

from neural_renderer_tpu_torch.config import load_config
from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.scene.scene import Scene
from neural_renderer_tpu_torch.train import (TrainConfig,
                                             make_train_step_on_batch,
                                             restore_checkpoint,
                                             sample_segment_batch,
                                             scene_global_row, segment_domain)
from neural_renderer_tpu_torch.train.trainer import _moments

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOT = os.path.join(ROOT, "configs", "knot")
CKPT = os.path.join(KNOT, "lane_ckpt", "step_48000")
CONFIG = os.path.join(KNOT, "knot_lane.json")
WEIGHTS = os.path.join(KNOT, "lane_step48000.npz")
STEPS = 48010
BATCH = 1536


@pytest.fixture(scope="module")
def exp():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import export_lane_ckpt_npz as module
    finally:
        sys.path.pop(0)
    return module


def test_export_writes_adam_npz(exp, tmp_path):
    """The export of the knot checkpoint writes the committed weights and
    optimizer arrays exactly, under the port's parameter names."""
    out = str(tmp_path / "knot.npz")
    exp.main(["export", CKPT, out, CONFIG])
    with np.load(out) as got, np.load(WEIGHTS) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert np.array_equal(got[k], want[k]), k
    with np.load(out[:-4] + ".adam.npz") as got, \
            np.load(WEIGHTS[:-4] + ".adam.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert np.array_equal(got[k], want[k]), k
        assert int(got["step"]) == 48000
        names = ["lane"] + [f"mlp_{i}" for i in range(5)]
        assert sorted(got.files) == sorted(
            ["step"] + [f"{m}_{n}" for m in ("exp_avg", "exp_avg_sq")
                        for n in names])
        assert np.abs(got["exp_avg_sq_mlp_0"]).max() > 0


def knot_batch(cfg):
    """BATCH segments (3 per ray) that the port's sampler draws from the
    knot scene with a seeded generator: the data the checkpoint was
    trained on."""
    scene = Scene.from_config(cfg)
    meshes = [getattr(scene, m).to_tensors("cpu")
              for m in ("original_mesh", "outer_shell", "inner_shell")]
    omin, inv, radius = segment_domain(scene, "cpu")
    b = sample_segment_batch(torch.Generator().manual_seed(5), *meshes,
                             omin, inv, BATCH, radius, segments_per_ray=3,
                             global_row=scene_global_row(scene, "cpu"))
    assert int(b.valid.sum()) > 300 and float(b.presence.sum()) > 200
    return b


def test_resumed_step_matches_jax(exp):
    """The port's first resumed step (from the two .npz files, no orbax)
    against the JAX trainer's restored step on the same batch."""
    cfg = load_config(CONFIG)
    config = nbvh.NbvhConfig.from_network_config(cfg.neural_network)
    batch = knot_batch(cfg)
    tcfg = TrainConfig(batch_size=BATCH, lr_schedule="cosine", steps=STEPS)
    state = restore_checkpoint(WEIGHTS, tcfg, config, "cpu")
    assert state.step == 48000
    p0 = [p.detach().clone() for p in state.net.parameters()]
    m0 = [m.clone() for m in _moments(state, "exp_avg")]
    v0 = [m.clone() for m in _moments(state, "exp_avg_sq")]
    state, metrics = make_train_step_on_batch(tcfg, config, "cpu")(state,
                                                                    batch)
    assert state.step == 48001

    jcfg = jtrainer.TrainConfig(batch_size=BATCH, lr_schedule="cosine",
                                steps=STEPS)
    jstate = jtrainer.restore_checkpoint(CKPT, jcfg,
                                         exp.network_config(CONFIG))
    jbatch = jds.SegmentBatch(**{k: jnp.asarray(v.numpy())
                                 for k, v in batch._asdict().items()})
    with jax.disable_jit():
        jstate, jmetrics = jtrainer.make_train_step_on_batch(
            jcfg, exp.network_config(CONFIG))(jstate, jbatch)
    assert int(jstate.step) == 48001
    for k in jmetrics:
        want = float(jmetrics[k])
        assert abs(float(metrics[k]) - want) <= 1e-5 * abs(want), k

    named = exp._named
    jp, jmu = named(jstate.params), named(jstate.opt_state[0].mu)
    names = convert.param_names(state.net)
    for i, (p, name) in enumerate(zip(state.net.parameters(), names)):
        d_mu = (_moments(state, "exp_avg")[i] - m0[i]).numpy()
        j_mu = jmu[name] - m0[i].numpy()
        assert np.abs(d_mu - j_mu).max() <= 2e-2 * np.abs(j_mu).max(), name
        upd = (p.detach() - p0[i]).numpy()
        j_upd = jp[name] - p0[i].numpy()
        touched = v0[i].numpy() > 1e-3 * v0[i].max().item()
        assert np.abs(upd - j_upd)[touched].max() <= \
            2e-2 * np.abs(j_upd).max(), name
