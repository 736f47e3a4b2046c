"""The studio scene's tiny quality gate through the port on the CPU.

The gate of tests/test_quality_gate.py for configs/studio/studio_lane.json
(96x54, 4 batches of 1 spp, the additional mesh off, the trained
`lane_step12000.npz`): ground truth against the neural frame at PSNR >=
21.0 dB (the JAX package recorded 22.02 dB). The port measured 22.02 dB.
`evaluate` on the studio config runs in tests/test_torch_evaluate.py.
"""

import os

import torch

from neural_renderer_tpu_torch import metrics
from neural_renderer_tpu_torch.config import (camera_basis_from_state,
                                              load_config,
                                              matrix_to_camera_state)
from neural_renderer_tpu_torch.render.renderer import RenderBasis, Renderer
from neural_renderer_tpu_torch.scene.scene import Scene

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "studio", "studio_lane.json")


def test_tiny_quality_gate():
    cfg = load_config(CONFIG)
    pos, yaw, pitch = matrix_to_camera_state(cfg.camera.matrix)
    pos = pos * cfg.original_mesh.scale
    renderer = Renderer(Scene.from_config(cfg), cfg.neural_network,
                        device="cpu")
    renderer.resize(96, 54)
    renderer.set_bounce_count(cfg.rendering.bounce_count)
    renderer.set_envmap_rotation(cfg.environment.rotation)
    renderer.set_use_additional_mesh(False)
    assert renderer.load_weights_from_file(cfg.checkpoint_path)
    renderer.set_camera_basis(RenderBasis(*camera_basis_from_state(
        yaw, pitch, cfg.camera.yfov)))
    renderer.set_use_neural_query(False)
    gt = renderer.render_accumulate(pos, 4, batch_spp=1)
    renderer.set_use_neural_query(True)
    neural = renderer.render_accumulate(pos, 4, batch_spp=1)
    psnr = metrics.compute_psnr(gt, neural)
    print(f"studio tiny gate: PSNR {psnr:.2f} dB (gate 21.0, JAX 22.02)")
    assert psnr >= 21.0
