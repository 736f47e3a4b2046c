"""Scene: the four meshes, the environment and the global material.

Port of `neural_renderer_tpu/scene/scene.py`: `Scene.from_config` loads the
meshes a RendererConfig names and applies its material block. The
environment is the procedural sky; a config that names an environment file
raises, because the HDR / EXR / LDR loaders are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..config import RendererConfig
from .materials import Material
from .mesh import HostMesh
from .mesh_loader import load_mesh_labeled


@dataclass
class Environment:
    """Procedural sky with the config's rotation and strength (which only a
    loaded map would read)."""
    rotation: float = 0.0
    strength: float = 1.0


@dataclass
class Scene:
    original_mesh: HostMesh = field(default_factory=HostMesh)
    inner_shell: HostMesh = field(default_factory=HostMesh)
    outer_shell: HostMesh = field(default_factory=HostMesh)
    additional_mesh: HostMesh = field(default_factory=HostMesh)
    environment: Environment = field(default_factory=Environment)
    global_material: Material = field(default_factory=Material.default)
    # Labels of the meshes a config named but whose file did not load.
    failed_meshes: list = field(default_factory=list)

    @staticmethod
    def from_config(config: RendererConfig) -> "Scene":
        """Load the scene a RendererConfig describes. A mesh whose file
        fails to load is reported on stderr, stays empty and is named in
        `failed_meshes`."""
        scene = Scene()
        for attr, label in (("original_mesh", "original"),
                            ("inner_shell", "inner shell"),
                            ("outer_shell", "outer shell"),
                            ("additional_mesh", "additional mesh")):
            entry = getattr(config, attr)
            loaded = load_mesh_labeled(entry.path, label, scale=entry.scale)
            if loaded is not None:
                setattr(scene, attr, loaded)
            elif entry.path:
                scene.failed_meshes.append(label)
        scene.apply_material_config(config)
        if config.environment.hdri_path:
            raise NotImplementedError(
                f"environment map '{config.environment.hdri_path}': the "
                "HDR / EXR / LDR loaders (neural_renderer_tpu/scene/envmap.py"
                ", exr*.py) are not ported yet")
        scene.environment = Environment(config.environment.rotation,
                                        config.environment.strength)
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
