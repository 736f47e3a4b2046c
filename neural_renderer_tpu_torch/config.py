"""Scene/renderer configuration: JSON schema + camera matrix math.

A copy of `neural_renderer_tpu/config.py` (this package imports nothing of
that one), same schema: a single JSON file describes the four scene meshes, checkpoint path, environment map,
camera (4x4 column-major world-to-camera matrix + yfov), rendering settings and
the Disney material override, plus the neural-network hyperparameters.
Relative paths are resolved against the config file's directory.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

import numpy as np

_DEFAULT_YFOV = 1.047198  # ~60 degrees in radians


@dataclass
class MeshConfig:
    path: str = ""
    scale: float = 1.0


@dataclass
class EnvironmentConfig:
    hdri_path: str = ""
    rotation: float = 0.0
    strength: float = 1.0


@dataclass
class CameraConfig:
    # 4x4 world-to-camera matrix, column-major (OpenGL/GLM convention).
    matrix: tuple = tuple(np.eye(4, dtype=np.float32).T.reshape(-1).tolist())
    yfov: float = _DEFAULT_YFOV
    move_speed: float = 0.0  # 0 = auto from mesh bounds


@dataclass
class RenderingConfig:
    total_samples: int = 2048
    bounce_count: int = 3
    width: int = 1920
    height: int = 1080


@dataclass
class MaterialConfig:
    base_color: tuple = (1.0, 1.0, 1.0)
    roughness: float = 1.0
    metallic: float = 0.0
    specular: float = 0.0
    specular_tint: float = 0.0
    anisotropy: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.0
    use_constant_neural_color: bool = False
    constant_neural_color: tuple = (0.8, 0.8, 0.8)


@dataclass
class NeuralNetworkConfig:
    log2_hashmap_size: int = 14
    base_resolution: int = 16
    use_neural_query: bool = False
    # Selects the lane-local hash grid ("lane") or the tcnn-compatible one
    # ("tcnn"); lane_sublanes*128 entries per table.
    grid_type: str = "tcnn"
    lane_sublanes: int = 8
    # Entries per f32 table lane: 2 packs two bf16-rounded entries per lane
    # (2x capacity at the same kernel gather count); 1 = legacy full-f32.
    lane_entry_pack: int = 2


@dataclass
class RendererConfig:
    original_mesh: MeshConfig = field(default_factory=MeshConfig)
    inner_shell: MeshConfig = field(default_factory=MeshConfig)
    outer_shell: MeshConfig = field(default_factory=MeshConfig)
    additional_mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_path: str = ""
    environment: EnvironmentConfig = field(default_factory=EnvironmentConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    rendering: RenderingConfig = field(default_factory=RenderingConfig)
    material: MaterialConfig = field(default_factory=MaterialConfig)
    neural_network: NeuralNetworkConfig = field(default_factory=NeuralNetworkConfig)


class ConfigError(ValueError):
    pass


def _resolve(config_dir: str, p: str) -> str:
    if not p or os.path.isabs(p):
        return p
    return os.path.join(config_dir, p)


def load_config(config_path: str) -> RendererConfig:
    """Parse a scene JSON into a RendererConfig."""
    with open(config_path, "r") as f:
        j = json.load(f)

    config_dir = os.path.dirname(os.path.abspath(config_path))
    cfg = RendererConfig()

    scene = j.get("scene", {})
    for key in ("original_mesh", "inner_shell", "outer_shell", "additional_mesh"):
        if key in scene:
            entry = scene[key]
            setattr(cfg, key, MeshConfig(
                path=_resolve(config_dir, entry.get("path", "")),
                scale=float(entry.get("scale", 1.0)),
            ))

    cfg.checkpoint_path = _resolve(config_dir, j.get("checkpoint_path", ""))

    if "environment" in j:
        env = j["environment"]
        cfg.environment = EnvironmentConfig(
            hdri_path=_resolve(config_dir, env.get("hdri_path", "")),
            rotation=float(env.get("rotation", 0.0)),
            strength=float(env.get("strength", 1.0)),
        )

    # The camera is mandatory.
    if "camera" not in j:
        raise ConfigError("Camera configuration missing")
    cam = j["camera"]
    matrix = cam.get("matrix")
    if not isinstance(matrix, list) or len(matrix) != 16:
        raise ConfigError("Camera matrix missing or invalid (must be array of 16 floats)")
    cfg.camera = CameraConfig(
        matrix=tuple(float(v) for v in matrix),
        yfov=float(cam.get("yfov", _DEFAULT_YFOV)),
        move_speed=float(cam.get("move_speed", 0.0)),
    )

    if "rendering" in j:
        r = j["rendering"]
        cfg.rendering = RenderingConfig(
            total_samples=int(r.get("total_samples", 2048)),
            bounce_count=int(r.get("bounce_count", 3)),
            width=int(r.get("width", 1920)),
            height=int(r.get("height", 1080)),
        )

    if "material" in j:
        m = j["material"]
        mat = MaterialConfig()
        bc = m.get("base_color")
        if isinstance(bc, list) and len(bc) == 3:
            mat.base_color = tuple(float(v) for v in bc)
        mat.roughness = float(m.get("roughness", 1.0))
        mat.metallic = float(m.get("metallic", 0.0))
        mat.specular = float(m.get("specular", 0.0))
        mat.specular_tint = float(m.get("specular_tint", 0.0))
        mat.anisotropy = float(m.get("anisotropy", 0.0))
        mat.sheen = float(m.get("sheen", 0.0))
        mat.sheen_tint = float(m.get("sheen_tint", 0.0))
        mat.clearcoat = float(m.get("clearcoat", 0.0))
        mat.clearcoat_gloss = float(m.get("clearcoat_gloss", 0.0))
        mat.use_constant_neural_color = bool(m.get("use_constant_neural_color", False))
        cnc = m.get("constant_neural_color")
        if isinstance(cnc, list) and len(cnc) == 3:
            mat.constant_neural_color = tuple(float(v) for v in cnc)
        cfg.material = mat

    if "neural_network" in j:
        nn = j["neural_network"]
        cfg.neural_network = NeuralNetworkConfig(
            log2_hashmap_size=int(nn.get("log2_hashmap_size", 14)),
            base_resolution=int(nn.get("base_resolution", 16)),
            use_neural_query=bool(nn.get("use_neural_query", False)),
            grid_type=str(nn.get("grid_type", "tcnn")),
            lane_sublanes=int(nn.get("lane_sublanes", 8)),
            lane_entry_pack=int(nn.get("lane_entry_pack", 2)),
        )

    return cfg


# ---------------------------------------------------------------------------
# Camera matrix <-> (position, yaw, pitch) conversions
# The config matrix is world-to-camera (view), column-major; position
# recovered as -R^T t.
# ---------------------------------------------------------------------------

def matrix_to_camera_state(matrix) -> tuple[np.ndarray, float, float]:
    """Returns (position[3], yaw_deg, pitch_deg)."""
    m = np.asarray(matrix, dtype=np.float64).reshape(-1)
    if m.size != 16:
        raise ConfigError("camera matrix must have 16 elements")
    tx, ty, tz = m[12], m[13], m[14]
    # Rows of the world-to-camera rotation (column-major storage).
    r00, r01, r02 = m[0], m[4], m[8]
    r10, r11, r12 = m[1], m[5], m[9]
    r20, r21, r22 = m[2], m[6], m[10]

    pos = np.array([
        -(r00 * tx + r10 * ty + r20 * tz),
        -(r01 * tx + r11 * ty + r21 * tz),
        -(r02 * tx + r12 * ty + r22 * tz),
    ])
    # Third row of the view matrix is -forward.
    forward = np.array([-r20, -r21, -r22])
    h_len = math.hypot(forward[0], forward[2])
    yaw = math.degrees(math.atan2(forward[2], forward[0]))
    pitch = math.degrees(math.atan2(forward[1], h_len))
    return pos.astype(np.float32), float(yaw), float(pitch)


def camera_basis_from_state(yaw_deg: float, pitch_deg: float, fov_y: float):
    """Camera basis (forward, right, up, fov_y) from yaw/pitch."""
    yaw = math.radians(yaw_deg)
    pitch = math.radians(pitch_deg)
    forward = np.array([
        math.cos(pitch) * math.cos(yaw),
        math.sin(pitch),
        math.cos(pitch) * math.sin(yaw),
    ])
    forward = forward / np.linalg.norm(forward)
    world_up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, world_up)
    rn = np.linalg.norm(right)
    right = np.array([1.0, 0.0, 0.0]) if rn < 1e-4 else right / rn
    up = np.cross(right, forward)
    up = up / np.linalg.norm(up)
    return (
        forward.astype(np.float32),
        right.astype(np.float32),
        up.astype(np.float32),
        float(fov_y),
    )
