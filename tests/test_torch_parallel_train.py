"""The port's dp/tp training and its multi-rank CLIs, on the CPU.

A 2 x 2 (dp, tp) world of four ranks over gloo is spawned once for the
module (tests/torch_parallel_checks.py::train_checks, joined within
120 s). It takes one step of three cases, each held to the same step in
one process, "tiny" also to the JAX package's
`make_train_step_on_batch` (run under `jax.disable_jit()`):
  * "tiny": the dry run's network (n_levels 2, MLP 2 x 32, lane S=2),
    through the plain forward (K6 takes 4 x 128 MLPs only);
  * "small": the 4 x 128 network of tests/test_torch_train.py's twin test
    (lane S=4), through apply_train (the K2 / K6 twins);
  * "split": "small" on a batch whose second half is mostly invalid, so
    the ranks' valid counts differ: the loss must use the whole batch's
    counts.
Tolerances: losses to 1e-6 relative; the first moments (0.1 x the
gradient after one step) within 1e-5 of their largest value through
apply_train (exact sums in the twin; the ranks only reorder f32 sums) and
within 1e-2 through the plain forward (autograd rounds each rank's partial
weight gradient to bf16, 2^-8 = 3.9e-3 per rounding); parameters to
1e-6 x their largest value wherever the moment exceeds 1e-3 of its largest
(smaller gradients may flip the sign of Adam's first update). Against JAX:
losses to 1e-5 relative and moments within 2e-2 of their largest value,
tests/test_torch_train.py's bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.parallel import shard_params_spec as jspec
from neural_renderer_tpu.train import dataset as jds
from neural_renderer_tpu.train import trainer as jtrainer

import torch_parallel_checks as checks
from torch_scenes import tiny_config

from neural_renderer_tpu_torch.cli import train as train_cli
from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.parallel import shard_params_spec
from neural_renderer_tpu_torch.parallel.dryrun import TINY
from neural_renderer_tpu_torch.parallel.launch import spawn
from neural_renderer_tpu_torch.train.trainer import loss_fn

torch.set_num_threads(1)

CASES = {"tiny": (TINY, "off", 64, 0, False),
         "small": (checks.SMALL, "auto", 128, 1, False),
         "split": (checks.SMALL, "auto", 128, 2, True)}


def _case(name):
    cfg, fused, b, seed, split = CASES[name]
    config = nbvh.NbvhConfig(**cfg)
    return config, fused, checks.train_batch(config, b, seed, split)


@pytest.fixture(scope="module")
def ranks():
    return spawn(checks.train_checks, 4, "cpu", join_timeout=120, threads=1)


@pytest.fixture(scope="module")
def single():
    return {name: checks.one_step(*_case(name)) for name in CASES}


def _jax_params(net):
    p = convert.params_to_numpy(net)
    return {"lane": jnp.asarray(p["lane"]),
            "mlp": [jnp.asarray(w) for w in p["mlp"]]}


@pytest.mark.parametrize("grid_type", ["lane", "tcnn"])
def test_shard_params_spec_matches_jax(grid_type):
    """The sharded axis of every parameter is the JAX package's: lane
    tables on S, tcnn tables on entries, MLP rows, the last layer's
    columns."""
    kw = dict(lane_sublanes=4, log2_hashmap_size=10, base_resolution=8)
    net = nbvh.init_params(nbvh.NbvhConfig(grid_type=grid_type, **kw),
                           torch.Generator().manual_seed(0), "cpu")
    jp = jnbvh.init_params(jax.random.PRNGKey(0),
                           jnbvh.NbvhConfig(grid_type=grid_type, **kw))
    got, want = shard_params_spec(net), jspec(jp)
    assert [s for s in got["mlp"]] == [tuple(s) for s in want["mlp"]]
    if grid_type == "lane":
        assert got["lane"] == tuple(want["lane"])
        assert got["lane"][3] == "tp"
    else:
        # The port's network holds one grid that the encoder slots share.
        assert got["grids"][0] == [tuple(s) for s in want["grids"][0]]


@pytest.mark.parametrize("name", list(CASES))
def test_dp_tp_step_equals_single_process(ranks, single, name):
    """Every rank's gathered step equals the single-process step (module
    docstring's tolerances)."""
    m, params, moments, _, _ = single[name]
    tol = 1e-2 if CASES[name][1] == "off" else 1e-5
    for r in ranks:
        rm, rparams, rmoments, _, _ = r[name]
        for k in m:
            assert abs(rm[k] - m[k]) <= 1e-6 * abs(m[k]), k
        for p, q, e, f in zip(params, rparams, moments, rmoments):
            top = e.abs().max()
            assert (e - f).abs().max() <= tol * top
            big = e.abs() > 1e-3 * top
            assert (p - q)[big].abs().max() <= 1e-6 * p.abs().max()


def test_loss_uses_global_counts(ranks, single):
    """The split batch gives the ranks different valid counts; the loss
    divides by the whole batch's, so it equals the single-process loss,
    and the mean of the ranks' own losses would not."""
    config, _, batch = _case("split")
    valid = [int(v.sum()) for v in torch.tensor_split(batch.valid, 4)]
    assert len(set(valid)) > 1
    want = single["split"][0]["total"]
    assert abs(ranks[0]["split"][0]["total"] - want) <= 1e-6 * want
    net = checks.train_net(config)
    with torch.no_grad():
        own = [float(loss_fn(net, type(batch)(*(x[..., i * 32:(i + 1) * 32]
                                                for x in batch)))[0])
               for i in range(4)]
    assert abs(np.mean(own) - want) > 1e-3 * want


def test_shard_shapes_and_bytes(ranks):
    """Each rank holds half of every parameter on its tp axis and half of
    the moments; the batch's rows split over the four ranks (130 rows:
    33, 33, 32, 32)."""
    config = nbvh.NbvhConfig(**checks.SMALL)
    full = [tuple(p.shape) for p in checks.train_net(config).parameters()]
    dims = [3] + [0] * 4 + [1]
    want = [tuple(s // 2 if i == d else s for i, s in enumerate(shape))
            for shape, d in zip(full, dims)]
    n_full = sum(int(np.prod(s)) * 4 for s in full)
    for r in ranks:
        assert r["small"][3] == want
        assert r["small"][4] == {"network_bytes": n_full // 2,
                                 "moment_bytes": n_full}
    assert [r["index"] for r in ranks] == [(i, 4) for i in range(4)]
    assert [r["rows"] for r in ranks] == [33, 33, 32, 32]


@pytest.mark.parametrize("name", ["tiny"])
def test_dp_tp_step_matches_jax(ranks, name):
    """The gathered dp2 x tp2 step against JAX make_train_step_on_batch
    (bf16, the XLA gradient) on the same params and batch."""
    config, _, batch = _case(name)
    jcfg = jnbvh.NbvhConfig(**{"grid_type": "lane", **CASES[name][0]})
    tcfg = jtrainer.TrainConfig(batch_size=batch.valid.shape[0],
                                learning_rate=3e-3)
    params = _jax_params(checks.train_net(config))
    state = jtrainer.TrainState(params, jtrainer.make_optimizer(tcfg).init(
        params), jnp.int32(0))
    jbatch = jds.SegmentBatch(**{k: jnp.asarray(v.numpy())
                                 for k, v in batch._asdict().items()})
    with jax.disable_jit():
        state, metrics = jtrainer.make_train_step_on_batch(tcfg, jcfg)(
            state, jbatch)
    mu = state.opt_state[0].mu
    jmu = [np.asarray(mu["lane"])] + [np.asarray(w) for w in mu["mlp"]]
    m, _, moments, _, _ = ranks[0][name]
    for k in m:
        assert abs(m[k] - float(metrics[k])) <= 1e-5 * abs(float(metrics[k]))
    for got, want in zip(moments, jmu):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_train_cli_dp_tp_cpu(tmp_path, capfd):
    """train --dp 2 --tp 2 --device cpu runs two steps on four ranks; rank
    0 prints the shard bytes and writes the checkpoint, which loads."""
    cfg = tiny_config(tmp_path)
    ckpt = str(tmp_path / "tiny_ckpt")
    assert train_cli.main([cfg, "--steps", "2", "--batch-size", "192",
                           "--segments-per-ray", "3", "--log-every", "1",
                           "--dp", "2", "--tp", "2", "--device", "cpu",
                           "--ckpt-dir", ckpt]) == 0
    out, err = capfd.readouterr()
    assert out.count("step 2/2 loss=") == 1 and "dp=2 tp=2" in out
    assert "rank network + moment bytes" in out and "gloo" in err
    weights = str(tmp_path / "tiny_step2.npz")
    assert f"final checkpoint: {weights}" in out
    saved = convert.load_params_npz(weights)
    assert saved["lane"].shape[3] == 2
    with np.load(weights[:-4] + ".adam.npz") as z:
        assert int(z["step"]) == 2
        assert z["exp_avg_lane"].shape == saved["lane"].shape
