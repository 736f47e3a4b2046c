"""Scene: the four meshes, the environment and the global material.

Port of `neural_renderer_tpu/scene/scene.py`: `Scene.from_config` loads the
meshes a RendererConfig names (nearest texture filtering on the original
and additional meshes, bilinear on the shells, as the reference), applies
its material block and loads the environment file it names (HDR, EXR or
PNG; none selects the procedural sky). A file that fails to load is
reported on stderr and recorded (`failed_meshes`, `environment_error`), so
an app can refuse to render without it; the reference's UV-sphere fallback
is not taken.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from ..config import RendererConfig
from .envmap import EnvironmentMap
from .materials import Material
from .mesh import HostMesh
from .mesh_loader import load_mesh_labeled


@dataclass
class Scene:
    original_mesh: HostMesh = field(default_factory=HostMesh)
    inner_shell: HostMesh = field(default_factory=HostMesh)
    outer_shell: HostMesh = field(default_factory=HostMesh)
    additional_mesh: HostMesh = field(default_factory=HostMesh)
    environment: EnvironmentMap = field(default_factory=EnvironmentMap)
    global_material: Material = field(default_factory=Material.default)
    # Labels of the meshes a config named but whose file did not load.
    failed_meshes: list = field(default_factory=list)
    # Why the environment file the config named did not load, else None.
    environment_error: str | None = None

    @staticmethod
    def from_config(config: RendererConfig) -> "Scene":
        """Load the scene a RendererConfig describes. A mesh whose file
        fails to load is reported on stderr, stays empty and is named in
        `failed_meshes`."""
        scene = Scene()
        for attr, label, nearest in (
                ("original_mesh", "original", True),
                ("inner_shell", "inner shell", False),
                ("outer_shell", "outer shell", False),
                ("additional_mesh", "additional mesh", True)):
            entry = getattr(config, attr)
            loaded = load_mesh_labeled(entry.path, label, scale=entry.scale,
                                       nearest_tex=nearest)
            if loaded is not None:
                setattr(scene, attr, loaded)
            elif entry.path:
                scene.failed_meshes.append(label)
        scene.apply_material_config(config)
        env = config.environment
        scene.environment = EnvironmentMap(env.rotation, env.strength)
        if env.hdri_path:
            try:
                scene.environment.load_from_file(env.hdri_path)
            except Exception as e:
                scene.environment_error = f"{type(e).__name__}: {e}"
                print(f"Failed to load HDRI '{env.hdri_path}': "
                      f"{scene.environment_error}", file=sys.stderr)
        return scene

    def apply_material_config(self, config: RendererConfig):
        """The config's material block replaces the global material; on
        per-mesh materials it replaces everything but the base color."""
        mc = config.material
        params = dict(
            roughness=mc.roughness, metallic=mc.metallic,
            specular=mc.specular, specular_tint=mc.specular_tint,
            anisotropy=mc.anisotropy, sheen=mc.sheen,
            sheen_tint=mc.sheen_tint, clearcoat=mc.clearcoat,
            clearcoat_gloss=mc.clearcoat_gloss)
        self.global_material = self.global_material.replace(
            base_color=tuple(float(x) for x in mc.base_color), **params)
        for mesh in (self.original_mesh, self.inner_shell, self.outer_shell,
                     self.additional_mesh):
            mesh.materials = [m.replace(**params) for m in mesh.materials]
