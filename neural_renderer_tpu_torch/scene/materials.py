"""Disney material model: host-side description and flat device tables.

Port of `neural_renderer_tpu/scene/materials.py`: the scalar-row and
texture-slot indices, `MaterialParam` / `MaterialParamVec3` (a constant or a
texture channel), `Material` with `scalar_row`, `tex_rows` and
`has_any_texture`, and `MaterialTable.build`, which packs every texture into
one flat texel atlas (uint8 texels / 255, others as float32; grey and
grey+alpha replicated to RGB). Unlike the reference, a `Material` field may
also be given as a plain number or an RGB tuple: it is stored as a constant.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

import numpy as np

# Scalar-constant table layout (indices into the per-material row).
P_BASE_R, P_BASE_G, P_BASE_B = 0, 1, 2
P_METALLIC = 3
P_ROUGHNESS = 4
P_SPECULAR = 5
P_SPECULAR_TINT = 6
P_ANISOTROPY = 7
P_SHEEN = 8
P_SHEEN_TINT = 9
P_CLEARCOAT = 10
P_CLEARCOAT_GLOSS = 11
P_EMISSION_R, P_EMISSION_G, P_EMISSION_B = 12, 13, 14
P_EMISSION_SCALE = 15
P_IOR = 16
P_SPEC_TRANS = 17
NUM_SCALARS = 18

# Texture-slot table layout.
T_BASE_COLOR = 0
T_METALLIC = 1
T_ROUGHNESS = 2
T_SPECULAR = 3
T_NORMAL = 4
T_EMISSION = 5
NUM_TEX_SLOTS = 6


@dataclass
class MaterialParam:
    """Scalar parameter: a constant value or a texture channel (0 R, 1 G,
    2 B)."""
    value: float = 0.0
    texture_id: int = -1
    channel: int = 0

    @property
    def textured(self) -> bool:
        return self.texture_id >= 0

    @staticmethod
    def constant(v: float) -> "MaterialParam":
        return MaterialParam(value=float(v))

    @staticmethod
    def texture(tex_id: int, channel: int = 0) -> "MaterialParam":
        return MaterialParam(texture_id=int(tex_id), channel=int(channel))


@dataclass
class MaterialParamVec3:
    """RGB parameter: a constant colour or a texture."""
    value: tuple = (0.0, 0.0, 0.0)
    texture_id: int = -1

    @property
    def textured(self) -> bool:
        return self.texture_id >= 0

    @staticmethod
    def constant(v) -> "MaterialParamVec3":
        return MaterialParamVec3(value=tuple(float(x) for x in v))

    @staticmethod
    def texture(tex_id: int) -> "MaterialParamVec3":
        return MaterialParamVec3(texture_id=int(tex_id))


def _const(v):
    return field(default_factory=lambda: MaterialParam.constant(v))


def _const3(v):
    return field(default_factory=lambda: MaterialParamVec3.constant(v))


@dataclass
class Material:
    """Disney principled material."""
    base_color: MaterialParamVec3 = _const3((0.8, 0.8, 0.8))
    metallic: MaterialParam = _const(0.0)
    roughness: MaterialParam = _const(0.0)
    specular: MaterialParam = _const(0.0)
    specular_tint: MaterialParam = _const(0.0)
    anisotropy: MaterialParam = _const(0.0)
    sheen: MaterialParam = _const(0.0)
    sheen_tint: MaterialParam = _const(0.0)
    clearcoat: MaterialParam = _const(0.0)
    clearcoat_gloss: MaterialParam = _const(1.0)
    normal: MaterialParamVec3 = _const3((0.0, 0.0, 0.0))
    base_emission: MaterialParamVec3 = _const3((0.0, 0.0, 0.0))
    emission_scale: float = 1.0
    ior: float = 1.5
    specular_transmission: float = 0.0

    def __post_init__(self):
        # Plain numbers and tuples become constants.
        for f in fields(self):
            v = getattr(self, f.name)
            if f.type == "MaterialParam" and not isinstance(v,
                                                            MaterialParam):
                setattr(self, f.name, MaterialParam.constant(v))
            elif f.type == "MaterialParamVec3" and not isinstance(
                    v, MaterialParamVec3):
                setattr(self, f.name, MaterialParamVec3.constant(v))

    @staticmethod
    def default() -> "Material":
        return Material()

    def replace(self, **kwargs) -> "Material":
        return replace(self, **kwargs)

    def has_any_texture(self) -> bool:
        return any(p.textured for p in (
            self.base_color, self.metallic, self.roughness, self.specular,
            self.specular_tint, self.anisotropy, self.sheen,
            self.sheen_tint, self.clearcoat, self.clearcoat_gloss,
            self.normal, self.base_emission))

    def scalar_row(self) -> np.ndarray:
        row = np.zeros(NUM_SCALARS, dtype=np.float32)
        row[P_BASE_R:P_BASE_B + 1] = self.base_color.value
        row[P_METALLIC] = self.metallic.value
        row[P_ROUGHNESS] = self.roughness.value
        row[P_SPECULAR] = self.specular.value
        row[P_SPECULAR_TINT] = self.specular_tint.value
        row[P_ANISOTROPY] = self.anisotropy.value
        row[P_SHEEN] = self.sheen.value
        row[P_SHEEN_TINT] = self.sheen_tint.value
        row[P_CLEARCOAT] = self.clearcoat.value
        row[P_CLEARCOAT_GLOSS] = self.clearcoat_gloss.value
        row[P_EMISSION_R:P_EMISSION_B + 1] = self.base_emission.value
        row[P_EMISSION_SCALE] = self.emission_scale
        row[P_IOR] = self.ior
        row[P_SPEC_TRANS] = self.specular_transmission
        return row

    def tex_rows(self) -> tuple[np.ndarray, np.ndarray]:
        tex = np.full(NUM_TEX_SLOTS, -1, dtype=np.int32)
        chan = np.zeros(NUM_TEX_SLOTS, dtype=np.int32)
        tex[T_BASE_COLOR] = self.base_color.texture_id
        tex[T_METALLIC] = self.metallic.texture_id
        chan[T_METALLIC] = self.metallic.channel
        tex[T_ROUGHNESS] = self.roughness.texture_id
        chan[T_ROUGHNESS] = self.roughness.channel
        tex[T_SPECULAR] = self.specular.texture_id
        chan[T_SPECULAR] = self.specular.channel
        tex[T_NORMAL] = self.normal.texture_id
        tex[T_EMISSION] = self.base_emission.texture_id
        return tex, chan


@dataclass
class MaterialTable:
    """Flat material tables and the packed texture atlas.

    scalars:   [M, NUM_SCALARS] f32
    tex_ids:   [M, NUM_TEX_SLOTS] i32 (-1 = use the constant)
    tex_chans: [M, NUM_TEX_SLOTS] i32
    atlas:     [P, 3] f32, every texture's texels concatenated
    tex_offset/tex_width/tex_height: [Ntex] i32, each texture's place
    """
    scalars: np.ndarray
    tex_ids: np.ndarray
    tex_chans: np.ndarray
    atlas: np.ndarray
    tex_offset: np.ndarray
    tex_width: np.ndarray
    tex_height: np.ndarray
    texture_nearest: bool = False

    @staticmethod
    def build(materials: list, textures: list,
              texture_nearest: bool = False) -> "MaterialTable":
        """textures: uint8 / uint16 / float arrays [H, W] or [H, W, C]."""
        m = max(1, len(materials))
        scalars = np.zeros((m, NUM_SCALARS), dtype=np.float32)
        tex_ids = np.full((m, NUM_TEX_SLOTS), -1, dtype=np.int32)
        tex_chans = np.zeros((m, NUM_TEX_SLOTS), dtype=np.int32)
        if materials:
            for i, mat in enumerate(materials):
                scalars[i] = mat.scalar_row()
                tex_ids[i], tex_chans[i] = mat.tex_rows()
        else:
            scalars[0] = Material.default().scalar_row()

        offsets, widths, heights, texels = [], [], [], []
        cursor = 0
        for tex in textures:
            t = np.asarray(tex)
            if t.dtype == np.uint8:
                t = t.astype(np.float32) / 255.0
            else:
                t = t.astype(np.float32)
            if t.ndim == 2:
                t = t[..., None]
            h, w = t.shape[:2]
            if t.shape[2] < 3:
                t = np.concatenate([t] + [t[..., :1]] * (3 - t.shape[2]),
                                   axis=-1)
            offsets.append(cursor)
            widths.append(w)
            heights.append(h)
            texels.append(t[..., :3].reshape(-1, 3))
            cursor += h * w
        if texels:
            atlas = np.concatenate(texels, axis=0).astype(np.float32)
        else:
            atlas = np.zeros((1, 3), dtype=np.float32)
            offsets, widths, heights = [0], [1], [1]
        return MaterialTable(
            scalars=scalars, tex_ids=tex_ids, tex_chans=tex_chans,
            atlas=atlas,
            tex_offset=np.asarray(offsets, dtype=np.int32),
            tex_width=np.asarray(widths, dtype=np.int32),
            tex_height=np.asarray(heights, dtype=np.int32),
            texture_nearest=texture_nearest)
