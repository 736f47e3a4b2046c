"""A tiny scene config for the port's app tests: OBJ UV spheres (original
of radius 1, shells of 0.8 and 1.2, 256 / 144 / 144 triangles) with
configs/sphere/sphere_lane.json's camera and material, a lane network of
S=2 and, on request, seeded weights at the config's checkpoint_path."""

import json
import os

import torch

from neural_renderer_tpu_torch.models import convert, nbvh
from neural_renderer_tpu_torch.scene.mesh import outward_sphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_obj(path, mesh):
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {float(v[0])!r} {float(v[1])!r} {float(v[2])!r}\n")
        for t in mesh.indices:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def tiny_config(tmp_path, weights=True, total_samples=4, width=24,
                height=16, bounces=1, original="original_mesh.obj"):
    """Write the scene into tmp_path; returns the config's path. `original`
    names the original mesh's file (written only under its own name)."""
    with open(os.path.join(ROOT, "configs", "sphere", "sphere_lane.json")) \
            as f:
        j = json.load(f)
    for key, stacks, r in (("original_mesh", 8, 1.0), ("inner_shell", 6, 0.8),
                           ("outer_shell", 6, 1.2)):
        _write_obj(tmp_path / f"{key}.obj", outward_sphere(stacks, 2 * stacks,
                                                           r))
        j["scene"][key]["path"] = f"{key}.obj"
    j["scene"]["original_mesh"]["path"] = original
    j["neural_network"].update(lane_sublanes=2)
    j["rendering"].update(total_samples=total_samples, width=width,
                          height=height, bounce_count=bounces)
    j["checkpoint_path"] = "tiny_ckpt/step_1"
    if weights:
        net = nbvh.init_params(
            nbvh.NbvhConfig(log2_hashmap_size=14, base_resolution=16,
                            grid_type="lane", lane_sublanes=2,
                            lane_entry_pack=2),
            torch.Generator().manual_seed(3), "cpu")
        convert.save_params_npz(str(tmp_path / "tiny_step1.npz"), net)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(j))
    return str(path)

