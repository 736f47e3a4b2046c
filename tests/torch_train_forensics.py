"""Training forensics: the port's trainer against the JAX package's, beyond
the 40 steps of tests/test_torch_train_long.py. A helper of the tests (it
imports both packages); run it as a script for the at-size measurements
that PERF.md cites, on the CPU.

    python tests/torch_train_forensics.py moments CONFIG WEIGHTS
        [--adam ADAM] [--batch B] [--batches K] [--segments-per-ray S]
    python tests/torch_train_forensics.py same-batch CONFIG WEIGHTS
        [--batch B] [--batches K]
    python tests/torch_train_forensics.py paired CONFIG --seed N --batch B
        --steps N --out PREFIX

moments: the mean gradient E[g] and the mean squared gradient E[g^2] of
every parameter at the weights WEIGHTS (a `.npz` of the lane grid), over K
batches of the port's sampler (a torch.Generator seeded with 7) and the
port's training gradient (K2's and K6's twins). With --adam (an `.adam.npz`
as `cli/train.py` or scripts/export_lane_ckpt_npz.py writes it beside
WEIGHTS), it prints per parameter, and per output row of the last layer,
the optimizer's second moment over E[g^2] and the correlation of its first
moment with E[g]: an Adam state that followed this gradient to the end of a
run shows a ratio of a few and a first moment along E[g].

same-batch: K batches drawn by the JAX sampler (keys split from
PRNGKey(1)) through JAX's training gradient (the XLA path, bf16, as
`make_train_step_on_batch` takes it) and the port's, at WEIGHTS; prints
each parameter's relative L2 difference and correlation on the first batch.

paired: the JAX trainer (`make_train_step_on_batch`, optax.adamw with its
cosine) and the port's from the same weights (JAX's `init_params` at
--seed) on the same JAX-sampled batches (keys from PRNGKey(1000), the same
for every seed), a cosine over --steps; writes every step's five loss
terms of both sides to PREFIX_losses.npy ([steps, 10]: JAX's total,
presence, distance, normal, color, then the port's), and at every 500th
and the last step both sides' weights (PREFIX_<step>_jax.npz,
PREFIX_<step>_port.npz) and Adam states (`.adam.npz`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from neural_renderer_tpu_torch import train  # noqa: E402
from neural_renderer_tpu_torch.config import load_config  # noqa: E402
from neural_renderer_tpu_torch.models import convert, nbvh  # noqa: E402
from neural_renderer_tpu_torch.scene.scene import Scene  # noqa: E402
from neural_renderer_tpu_torch.train import trainer  # noqa: E402

LOSS_KEYS = ("total", "presence", "distance", "normal", "color")


def port_net(config, weights_npz):
    """The port's trainable network of a config's lane grid, from a
    weights `.npz` or from numpy params."""
    cfg = nbvh.NbvhConfig.from_network_config(
        load_config(config).neural_network)
    params = (convert.load_params_npz(weights_npz)
              if isinstance(weights_npz, str) else weights_npz)
    net = convert.params_from_numpy(params, cfg, device="cpu")
    net.requires_grad_(True)
    return net


def port_grads(net, batch):
    """The port's training gradient (K2 / K6 twins) of shell_losses on a
    SegmentBatch, one numpy array per parameter."""
    for p in net.parameters():
        p.grad = None
    total, _ = trainer.loss_fn(net, batch, True)
    total.backward()
    return [p.grad.numpy().copy() for p in net.parameters()]


def gradient_moments(config, weights, batch, batches, segments_per_ray=1,
                     seed=7):
    """{name: (E[g], E[g^2])} at `weights` over `batches` batches of the
    port's sampler."""
    cfg = load_config(config)
    scene = Scene.from_config(cfg)
    meshes = [m.to_tensors("cpu") for m in (scene.original_mesh,
                                            scene.outer_shell,
                                            scene.inner_shell)]
    omin, inv, radius = train.segment_domain(scene, "cpu")
    row = train.scene_global_row(scene, "cpu")
    net = port_net(config, weights)
    names = convert.param_names(net)
    gen = torch.Generator().manual_seed(seed)
    g1 = [0.0] * len(names)
    g2 = [0.0] * len(names)
    for _ in range(batches):
        with torch.no_grad():
            b = train.sample_segment_batch(gen, *meshes, omin, inv, batch,
                                           radius, segments_per_ray,
                                           global_row=row)
        for i, g in enumerate(port_grads(net, b)):
            g1[i] = g1[i] + g / batches
            g2[i] = g2[i] + g * g / batches
    return {n: (g1[i], g2[i]) for i, n in enumerate(names)}


def _corr(a, b):
    a, b = np.ravel(a), np.ravel(b)
    if a.std() == 0 or b.std() == 0:
        return float("nan")
    return float(np.corrcoef(a, b)[0, 1])


def adam_signature(moments, adam_npz, out_rows=8):
    """Per parameter (and per output row of the last layer): the second
    moment over E[g^2] (ratio of means; median of ratios for the rows) and
    the correlation of the first moment with E[g]."""
    out = {}
    with np.load(adam_npz) as z:
        for name, (g1, g2) in moments.items():
            mu, nu = z[f"exp_avg_{name}"], z[f"exp_avg_sq_{name}"]
            out[name] = (float(nu.mean() / g2.mean()), _corr(mu, g1))
        last = [n for n in moments if n.startswith("mlp_")][-1]
        g1, g2 = moments[last]
        mu, nu = z[f"exp_avg_{last}"], z[f"exp_avg_sq_{last}"]
        out["rows"] = [(float(np.median(nu[r] / np.maximum(g2[r], 1e-30))),
                        _corr(mu[r], g1[r])) for r in range(out_rows)]
    return out


def _jax_setup(config, batch, segments_per_ray=1):
    """(sample(key) -> JAX SegmentBatch, the JAX NbvhConfig)."""
    import jax

    from neural_renderer_tpu.config import load_config as jload
    from neural_renderer_tpu.models import nbvh as jnbvh
    from neural_renderer_tpu.scene.scene import Scene as JScene
    from neural_renderer_tpu.train import dataset as jds
    from neural_renderer_tpu.train import trainer as jtr

    jc = jload(config)
    js = JScene.from_config(jc, sphere_fallback=False)
    nn = jc.neural_network
    jcfg = jnbvh.NbvhConfig(log2_hashmap_size=nn.log2_hashmap_size,
                            base_resolution=nn.base_resolution,
                            grid_type=nn.grid_type,
                            lane_sublanes=nn.lane_sublanes,
                            lane_entry_pack=nn.lane_entry_pack)
    meshes = [m.to_arrays() for m in (js.original_mesh, js.outer_shell,
                                      js.inner_shell)]
    omin, inv, radius = jtr.segment_domain(js)
    row = jtr.scene_global_row(js)
    sample = jax.jit(lambda k: jds.sample_segment_batch(
        k, *meshes, omin, inv, batch, radius, segments_per_ray,
        global_row=row))
    return sample, jcfg


def port_batch(jbatch):
    """A JAX SegmentBatch as the port's."""
    return train.SegmentBatch(**{k: torch.from_numpy(np.array(v))
                                 for k, v in jbatch._asdict().items()})


def same_batch_grads(config, weights, batch, batches):
    """[(name, relative L2 of port - JAX, correlation)] per batch: both
    training gradients at `weights` on JAX-sampled batches."""
    import jax
    import jax.numpy as jnp

    from neural_renderer_tpu.train import trainer as jtr

    sample, jcfg = _jax_setup(config, batch)
    p = convert.load_params_npz(weights)
    jp = {"lane": jnp.asarray(p["lane"]),
          "mlp": [jnp.asarray(w) for w in p["mlp"]]}
    jgrad = jax.jit(jax.grad(lambda params, b: jtr.loss_fn(
        params, b, jcfg, jnp.bfloat16)[0]))
    net = port_net(config, p)
    names = convert.param_names(net)
    key = jax.random.PRNGKey(1)
    out = []
    for _ in range(batches):
        key, sk = jax.random.split(key)
        jb = sample(sk)
        g = jgrad(jp, jb)
        jg = [np.asarray(g["lane"])] + [np.asarray(w) for w in g["mlp"]]
        tg = port_grads(net, port_batch(jb))
        out.append([(n, float(np.linalg.norm(t - j.reshape(t.shape))
                              / np.linalg.norm(j)), _corr(j, t))
                    for n, j, t in zip(names, jg, tg)])
    return out


def paired_run(config, seed, batch, steps, out, lr=1e-3, log_every=100):
    """Both trainers from JAX's init at `seed` on the same JAX-sampled
    batches; see the module docstring for the files written."""
    import jax
    import jax.numpy as jnp

    from neural_renderer_tpu.models import nbvh as jnbvh
    from neural_renderer_tpu.train import trainer as jtr

    sample, jcfg = _jax_setup(config, batch)
    jp = jnbvh.init_params(jax.random.PRNGKey(seed), jcfg)
    p0 = {"lane": np.asarray(jp["lane"]),
          "mlp": [np.asarray(w) for w in jp["mlp"]]}
    jt = jtr.TrainConfig(batch_size=batch, steps=steps, learning_rate=lr,
                         lr_schedule="cosine")
    jstate = jtr.TrainState(jp, jtr.make_optimizer(jt).init(jp),
                            jnp.int32(0))
    jstep = jtr.make_train_step_on_batch(jt, jcfg)
    tc = train.TrainConfig(batch_size=batch, steps=steps, learning_rate=lr,
                           lr_schedule="cosine")
    net = port_net(config, p0)
    state = trainer.TrainState(net, *train.make_optimizer(tc,
                                                          net.parameters()))
    tstep = train.make_train_step_on_batch(tc, net.config, "cpu")
    names = convert.param_names(net)

    def dump(tag):
        jparams = [jstate.params["lane"], *jstate.params["mlp"]]
        np.savez(f"{out}_{tag}_jax.npz", **{
            n: np.asarray(a) for n, a in zip(names, jparams)})
        convert.save_params_npz(f"{out}_{tag}_port.npz", state.net)
        adam = jstate.opt_state[0]
        mus = [adam.mu["lane"], *adam.mu["mlp"]]
        nus = [adam.nu["lane"], *adam.nu["mlp"]]
        np.savez(f"{out}_{tag}_jax.adam.npz", **{
            f"exp_avg_{n}": np.asarray(m) for n, m in zip(names, mus)}, **{
            f"exp_avg_sq_{n}": np.asarray(v) for n, v in zip(names, nus)})
        st = [state.optimizer.state[q] for q in state.net.parameters()]
        np.savez(f"{out}_{tag}_port.adam.npz", **{
            f"exp_avg_{n}": s["exp_avg"].numpy() for n, s in zip(names, st)},
            **{f"exp_avg_sq_{n}": s["exp_avg_sq"].numpy()
               for n, s in zip(names, st)})
        np.save(f"{out}_losses.npy", np.array(losses))

    key = jax.random.PRNGKey(1000)
    losses = []
    t0 = time.time()
    for i in range(steps):
        key, sk = jax.random.split(key)
        jb = sample(sk)
        jstate, jm = jstep(jstate, jb)
        state, tm = tstep(state, port_batch(jb))
        losses.append([float(jm[k]) for k in LOSS_KEYS]
                      + [float(tm[k]) for k in LOSS_KEYS])
        if (i + 1) % log_every == 0 or i == 0:
            print(f"{i + 1} jax {losses[-1][0]:.5f} port "
                  f"{losses[-1][5]:.5f} {time.time() - t0:.1f} s",
                  flush=True)
        if (i + 1) % 500 == 0 or i + 1 == steps:
            dump(str(i + 1))
    return np.array(losses)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("moments", "same-batch", "paired"))
    p.add_argument("config")
    p.add_argument("weights", nargs="?")
    p.add_argument("--adam", default="")
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--batches", type=int, default=16)
    p.add_argument("--segments-per-ray", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--out", default="paired")
    p.add_argument("--threads", type=int, default=2)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    if args.mode == "moments":
        m = gradient_moments(args.config, args.weights, args.batch,
                             args.batches, args.segments_per_ray)
        for n, (g1, g2) in m.items():
            print(f"{n}: E[g^2] {g2.mean():.4e}, E[g]^2 {(g1 ** 2).mean():.4e}")
        if args.adam:
            sig = adam_signature(m, args.adam)
            rows = sig.pop("rows")
            for n, (ratio, c) in sig.items():
                print(f"{n}: nu / E[g^2] {ratio:.2f}, corr(mu, E[g]) "
                      f"{c:.3f}")
            print("output rows, nu / E[g^2]: " + " ".join(
                f"{r:.1f}" for r, _ in rows))
            print("output rows, corr(mu, E[g]): " + " ".join(
                f"{c:.2f}" for _, c in rows))
    elif args.mode == "same-batch":
        rows = same_batch_grads(args.config, args.weights, args.batch,
                                args.batches)
        for n, rel, c in rows[0]:
            print(f"{n}: relative L2 {rel:.4f}, correlation {c:.6f}")
        worst = max(rel for r in rows for _, rel, _ in r)
        print(f"largest relative L2 over {len(rows)} batches: {worst:.4f}")
    else:
        paired_run(args.config, args.seed, args.batch, args.steps,
                   args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
