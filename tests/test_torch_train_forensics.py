"""The training forensics of tests/torch_train_forensics.py at a small size:
the port's training gradient against JAX's at the JAX-trained lane sphere's
weights on segments of the real sphere scene that the JAX sampler drew, and
the Adam-state comparison the helper prints.

The 40-step run of tests/test_torch_train_long.py starts from seeded
weights on the two-lobe test shells; this holds the gradient where a long
run ends, at trained weights, where the bf16 flips of ROADMAP Queue 3 set
the floor: measured 0.19-0.39% in L2 per parameter at 1,024 segments.
"""

import os

import numpy as np
import torch

import torch_train_forensics as forensics

# One intra-op thread: the suite runs several pytest workers side by side.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs/sphere/sphere_lane.json")
WEIGHTS = os.path.join(ROOT, "configs/sphere/lane16_step24000.npz")
GRAD_TOL = 2e-2        # relative L2 of (port - JAX) per parameter


def test_gradient_at_trained_weights_matches_jax():
    rows = forensics.same_batch_grads(CONFIG, WEIGHTS, 1024, 1)
    for name, rel, corr in rows[0]:
        print(f"{name}: relative L2 {rel:.2e}, correlation {corr:.7f}")
        assert rel <= GRAD_TOL, name
        assert corr >= 0.9999, name


def test_adam_signature_of_the_gradient_itself(tmp_path):
    """An Adam state whose moments are the gradient's own E[g] and E[g^2]
    reads a ratio of 1 and a correlation of 1 everywhere."""
    moments = forensics.gradient_moments(CONFIG, WEIGHTS, 256, 2)
    adam = tmp_path / "own.adam.npz"
    np.savez(adam, **{f"exp_avg_{n}": g1 for n, (g1, _) in moments.items()},
             **{f"exp_avg_sq_{n}": g2 for n, (_, g2) in moments.items()})
    sig = forensics.adam_signature(moments, str(adam))
    rows = sig.pop("rows")
    assert set(sig) == {"lane", "mlp_0", "mlp_1", "mlp_2", "mlp_3", "mlp_4"}
    for name, (ratio, corr) in sig.items():
        assert abs(ratio - 1) < 1e-6 and abs(corr - 1) < 1e-6, name
    assert len(rows) == 8
    for r, (ratio, corr) in enumerate(rows):
        # rows 0-7 carry presence, distance, normal and colour
        assert abs(ratio - 1) < 1e-6 and abs(corr - 1) < 1e-6, r
