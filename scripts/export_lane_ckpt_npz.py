"""Export a lane-grid orbax checkpoint of the JAX package to the numpy files
that the PyTorch port (`neural_renderer_tpu_torch`) reads without JAX or
orbax: the network params and, beside them, the optimizer state.

    python scripts/export_lane_ckpt_npz.py \
        [configs/sphere/lane16_ckpt/step_24000] \
        [configs/sphere/lane16_step24000.npz] \
        [configs/sphere/sphere_lane.json]

The checkpoint is restored with `train/trainer.py::restore_checkpoint` under
the network settings of the scene config given third (default
sphere_lane.json: lane grid, S=16, entry_pack=2), so the knot, sphere and
studio checkpoints each export under their own config. Written:

  * `<out>.npz`: `lane` ([P, L, F, S, 2, 128] f32) and `mlp_0` ...
    `mlp_4` ([out, in] f32), which
    `neural_renderer_tpu_torch/models/convert.py::load_params_npz` reads;
  * `<out>.adam.npz`: optax's Adam moments as torch AdamW's, `exp_avg_<name>`
    (mu) and `exp_avg_sq_<name>` (nu) per parameter, and `step`, the
    checkpoint's step, which equals optax's Adam count and its schedule's
    count (checked), so the port's `train --resume <out>.npz` takes the next
    step with the JAX trainer's moments, bias correction and learning rate.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CKPT = os.path.join(ROOT, "configs", "sphere", "lane16_ckpt",
                            "step_24000")
DEFAULT_OUT = os.path.join(ROOT, "configs", "sphere", "lane16_step24000.npz")
DEFAULT_CONFIG = os.path.join(ROOT, "configs", "sphere", "sphere_lane.json")


def network_config(config_path: str = DEFAULT_CONFIG):
    """The JAX NbvhConfig of a scene config's `neural_network` block."""
    from neural_renderer_tpu.models import nbvh
    with open(config_path) as f:
        nn = json.load(f)["neural_network"]
    return nbvh.NbvhConfig(log2_hashmap_size=nn["log2_hashmap_size"],
                           base_resolution=nn["base_resolution"],
                           grid_type=nn["grid_type"],
                           lane_sublanes=nn["lane_sublanes"],
                           lane_entry_pack=nn["lane_entry_pack"])


def sphere_lane_config():
    return network_config(DEFAULT_CONFIG)


def restore_state(ckpt_path: str, net_config=None):
    """The checkpoint's TrainState (params, optax state, step)."""
    from neural_renderer_tpu.train.trainer import (TrainConfig,
                                                   restore_checkpoint)
    return restore_checkpoint(ckpt_path, TrainConfig(),
                              net_config or sphere_lane_config())


def _named(tree) -> dict:
    """{"lane" | "mlp_<i>": f32 array} of a params-shaped pytree."""
    return {"lane": np.asarray(tree["lane"], np.float32),
            **{f"mlp_{i}": np.asarray(w, np.float32)
               for i, w in enumerate(tree["mlp"])}}


def restore_params(ckpt_path: str, net_config=None):
    """The checkpoint's network params as numpy arrays."""
    state = restore_state(ckpt_path, net_config)
    return {"lane": np.asarray(state.params["lane"], np.float32),
            "mlp": [np.asarray(w, np.float32) for w in state.params["mlp"]]}


def adam_arrays(state) -> dict:
    """The `.adam.npz` arrays of a TrainState: optax's mu and nu as
    exp_avg_<name> and exp_avg_sq_<name>, and the step. Raises if optax's
    counts disagree with the step."""
    adam = state.opt_state[0]
    step = int(state.step)
    counts = [int(s.count) for s in state.opt_state
              if "count" in getattr(s, "_fields", ())]
    if any(c != step for c in counts):
        raise ValueError(f"optax counts {counts} differ from step {step}")
    arrays = {"step": np.int64(step)}
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        arrays.update({f"{key}_{name}": a
                       for name, a in _named(tree).items()})
    return arrays


def main(argv):
    ckpt = argv[1] if len(argv) > 1 else DEFAULT_CKPT
    out = argv[2] if len(argv) > 2 else DEFAULT_OUT
    config = argv[3] if len(argv) > 3 else DEFAULT_CONFIG
    state = restore_state(ckpt, network_config(config))
    params = _named(state.params)
    np.savez_compressed(out, **params)
    adam = out[:-len(".npz")] + ".adam.npz"
    np.savez_compressed(adam, **adam_arrays(state))
    print(f"wrote {out}: " + ", ".join(f"{k} {v.shape}"
                                       for k, v in params.items()))
    print(f"wrote {adam}: step {int(state.step)}")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv)
