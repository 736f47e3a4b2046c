"""Parity of the port's fused lane-grid network (K2) with the JAX package.

The PyTorch twin is held to the Pallas kernel itself, run in interpret mode
on the CPU (`lane_grid_kernel.forward_lane(..., interpret=True)`), and to
the JAX XLA path (`nbvh.apply`). Weights are carried with
`models/convert.py::params_from_numpy`; tables are scaled up and pre-rounded
to bf16 (tests/test_lane_grid.py's trick) so the packed-entry rounding is a
no-op and the comparison sees only bf16 matmul rounding: max|d| / max|ref| <
2e-2, the budget of tests/test_lane_grid.py. The CUDA kernel is held to the
twin on the GPU by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_renderer_tpu.models import nbvh as jnbvh
from neural_renderer_tpu.ops.lane_grid_kernel import forward_lane as jforward

from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.ops import lane_grid_kernel

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

N = 300


def _setup(entry_pack):
    jcfg = jnbvh.NbvhConfig(grid_type="lane", lane_sublanes=4,
                            lane_entry_pack=entry_pack)
    params = jnbvh.init_params(jax.random.PRNGKey(0), jcfg)
    params["lane"] = (params["lane"] * 1e3).astype(jnp.bfloat16) \
        .astype(jnp.float32)
    x = np.random.default_rng(1).uniform(size=(jcfg.input_dims, N)) \
        .astype(np.float32)
    active = np.zeros(N, bool)
    active[:100] = np.random.default_rng(2).uniform(size=100) < 0.3
    active[256:] = True       # block 1 (rays 128..255) is dead
    net = convert.params_from_numpy(
        {"lane": np.asarray(params["lane"]),
         "mlp": [np.asarray(w) for w in params["mlp"]]},
        nbvh.NbvhConfig(lane_sublanes=4, lane_entry_pack=entry_pack),
        device="cpu")
    return jcfg, params, x, active, net


def _rel(out, ref):
    return np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9)


@pytest.mark.parametrize("entry_pack", [1, 2])
def test_twin_matches_interpreted_kernel(entry_pack):
    """With `active`: live blocks within 2e-2 of the interpreted Pallas
    kernel, the dead 128-ray block zero in both."""
    jcfg, params, x, active, net = _setup(entry_pack)
    ref = np.asarray(jforward(params, jnp.asarray(x), jcfg, interpret=True,
                              active=jnp.asarray(active)))
    out = lane_grid_kernel.forward_lane(net, torch.as_tensor(x),
                                        active=torch.as_tensor(active))
    out = out.numpy()
    assert out.shape == ref.shape == (16, N)
    assert (ref[:, 128:256] == 0).all() and (out[:, 128:256] == 0).all()
    assert _rel(out, ref) < 2e-2


@pytest.mark.parametrize("entry_pack", [1, 2])
def test_twin_matches_xla_network(entry_pack):
    """Without `active`: every ray within 2e-2 of the JAX XLA path."""
    jcfg, params, x, _, net = _setup(entry_pack)
    ref = np.asarray(jnbvh.apply(params, jnp.asarray(x), jcfg,
                                 compute_dtype=jnp.bfloat16))
    out = nbvh.apply(net, torch.as_tensor(x)).numpy()
    assert _rel(out, ref) < 2e-2


def test_table_packing_round_trip():
    """Two bf16 entries per 32-bit word, half 0 in the low 16 bits; the
    twin's unpack returns exactly the bf16-rounded entries."""
    t = torch.randn((3, 2, 4, 4, 2, 128), generator=torch.Generator()
                    .manual_seed(3))
    words, pack = lane_grid_kernel.pack_lane_tables(t)
    assert pack == 2 and words.shape == (3 * 2 * 4 * 4, 128)
    u = words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lo = (t[..., 0, :].to(torch.bfloat16).view(torch.int16).to(torch.int64)
          & 0xFFFF).reshape(-1, 128)
    assert torch.equal(u & 0xFFFF, lo)
    back = lane_grid_kernel._unpack_words(words, t.shape)
    assert torch.equal(back, t.to(torch.bfloat16).to(torch.float32))
