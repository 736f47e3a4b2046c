"""Disney principled BRDF of the plain reference: evaluation and the
3-component sampler.

A frozen copy of the port's `ops/brdf.py` (itself a port of the
reference renderer's `disney_brdf.cuh`), kept here so that a change to the
program cannot move its own yardstick. The reference renderer's two quirks
are kept: sample_ggx / sample_gtr_1_h use sin_theta = 1 - cos^2, and the
specular PDF uses unclamped n.h / h.o.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vec import cross, dot, lerp, luminance, normalize, reflect, where3

INV_PI = 0.31830988618379067154
TWO_PI = 6.283185307179586


class BrdfMaterial(NamedTuple):
    base_color: torch.Tensor       # [3, N]
    metallic: torch.Tensor         # [N]
    roughness: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    anisotropy: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    ior: torch.Tensor
    specular_transmission: torch.Tensor

    @staticmethod
    def broadcast_from_row(row, n: int) -> "BrdfMaterial":
        """Expand a global-material scalar row [NUM_SCALARS] to [N]."""
        from .vec import (
            P_ANISOTROPY, P_BASE_B, P_BASE_R, P_CLEARCOAT, P_CLEARCOAT_GLOSS,
            P_IOR, P_METALLIC, P_ROUGHNESS, P_SHEEN, P_SHEEN_TINT,
            P_SPECULAR, P_SPECULAR_TINT, P_SPEC_TRANS)

        def b(i):
            return row[i].expand(n)

        return BrdfMaterial(
            base_color=row[P_BASE_R:P_BASE_B + 1][:, None].expand(3, n),
            metallic=b(P_METALLIC), roughness=b(P_ROUGHNESS),
            specular=b(P_SPECULAR), specular_tint=b(P_SPECULAR_TINT),
            anisotropy=b(P_ANISOTROPY), sheen=b(P_SHEEN),
            sheen_tint=b(P_SHEEN_TINT), clearcoat=b(P_CLEARCOAT),
            clearcoat_gloss=b(P_CLEARCOAT_GLOSS), ior=b(P_IOR),
            specular_transmission=b(P_SPEC_TRANS))


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def schlick_weight(cos_theta):
    m = saturate(1.0 - cos_theta)
    return (m * m) * (m * m) * m


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    g2 = (eta_t * eta_t) / (eta_i * eta_i) - 1.0 + cos_theta_i * cos_theta_i
    g = torch.sqrt(torch.clamp(g2, min=0.0))
    a = (g - cos_theta_i) / (g + cos_theta_i)
    b = ((cos_theta_i * (g + cos_theta_i) - 1.0)
         / (cos_theta_i * (g - cos_theta_i) + 1.0))
    f = 0.5 * a * a * (1.0 + b * b)
    return torch.where(g2 < 0.0, torch.ones_like(f), f)


def gtr_1(cos_theta_h, alpha):
    a2 = alpha * alpha
    dense = INV_PI * (a2 - 1.0) / (torch.log(a2) * (
        1.0 + (a2 - 1.0) * cos_theta_h * cos_theta_h))
    return torch.where(alpha >= 1.0, torch.full_like(dense, INV_PI), dense)


def gtr_2(cos_theta_h, alpha):
    a2 = alpha * alpha
    denom = 1.0 + (a2 - 1.0) * cos_theta_h * cos_theta_h
    return INV_PI * a2 / (denom * denom)


def gtr_2_aniso(h_dot_n, h_dot_x, h_dot_y, alpha_x, alpha_y):
    q = ((h_dot_x / alpha_x) ** 2 + (h_dot_y / alpha_y) ** 2
         + h_dot_n * h_dot_n)
    return INV_PI / (alpha_x * alpha_y * (q * q))


def smith_shadowing_ggx(n_dot_o, alpha_g):
    a = alpha_g * alpha_g
    b = n_dot_o * n_dot_o
    return 1.0 / (n_dot_o + torch.sqrt(torch.clamp(a + b - a * b, min=0.0)))


def smith_shadowing_ggx_aniso(n_dot_o, o_dot_x, o_dot_y, alpha_x, alpha_y):
    return 1.0 / (n_dot_o + torch.sqrt(
        (o_dot_x * alpha_x) ** 2 + (o_dot_y * alpha_y) ** 2 + n_dot_o ** 2))


def same_hemisphere(wo, wi, n):
    return dot(wo, n) * dot(wi, n) > 0.0


def _tint(base_color):
    lum = luminance(base_color)
    safe = torch.where(lum > 0.0, lum, torch.ones_like(lum))
    return torch.where((lum > 0.0)[None, :], base_color / safe[None, :],
                       torch.ones_like(base_color))


def disney_diffuse(mat, n, wo, wi):
    w_h = normalize(wi + wo, eps=1e-20)
    n_dot_o = torch.abs(dot(wo, n))
    n_dot_i = torch.abs(dot(wi, n))
    i_dot_h = dot(wi, w_h)
    fd90 = 0.5 + 2.0 * mat.roughness * i_dot_h * i_dot_h
    fi = schlick_weight(n_dot_i)
    fo = schlick_weight(n_dot_o)
    w = lerp(1.0, fd90, fi) * lerp(1.0, fd90, fo)
    return mat.base_color * (INV_PI * w)[None, :]


def disney_sheen(mat, n, wo, wi):
    w_h = normalize(wi + wo, eps=1e-20)
    sheen_color = lerp(torch.ones_like(mat.base_color), _tint(mat.base_color),
                       mat.sheen_tint[None, :])
    f = schlick_weight(dot(wi, w_h))
    return sheen_color * (f * mat.sheen)[None, :]


def disney_clear_coat(mat, n, wo, wi):
    w_h = normalize(wi + wo, eps=1e-20)
    alpha = lerp(0.1, 0.001, mat.clearcoat_gloss)
    d = gtr_1(dot(n, w_h), alpha)
    f = lerp(0.04, 1.0, schlick_weight(dot(wi, n)))
    g = (smith_shadowing_ggx(dot(n, wi), 0.25)
         * smith_shadowing_ggx(dot(n, wo), 0.25))
    return 0.25 * mat.clearcoat * d * f * g


def _spec_color(mat):
    spec_base = lerp(torch.ones_like(mat.base_color), _tint(mat.base_color),
                     mat.specular_tint[None, :])
    spec = (mat.specular * 0.08)[None, :] * spec_base
    return lerp(spec, mat.base_color, mat.metallic[None, :])


def disney_microfacet_isotropic(mat, n, wo, wi):
    w_h = normalize(wi + wo, eps=1e-20)
    spec = _spec_color(mat)
    alpha = torch.clamp(mat.roughness * mat.roughness, min=0.001)
    d = gtr_2(dot(n, w_h), alpha)
    f = lerp(spec, torch.ones_like(spec),
             schlick_weight(dot(wi, w_h))[None, :])
    g = (smith_shadowing_ggx(dot(n, wi), alpha)
         * smith_shadowing_ggx(dot(n, wo), alpha))
    return f * (d * g)[None, :]


def _aniso_alphas(mat):
    aspect = torch.sqrt(torch.clamp(1.0 - mat.anisotropy * 0.9, min=0.0))
    a = mat.roughness * mat.roughness
    return (torch.clamp(a / aspect, min=0.001),
            torch.clamp(a * aspect, min=0.001))


def disney_microfacet_anisotropic(mat, n, wo, wi, tangent, bitangent):
    w_h = normalize(wi + wo, eps=1e-20)
    spec = _spec_color(mat)
    ax, ay = _aniso_alphas(mat)
    d = gtr_2_aniso(dot(n, w_h), torch.abs(dot(w_h, tangent)),
                    torch.abs(dot(w_h, bitangent)), ax, ay)
    f = lerp(spec, torch.ones_like(spec),
             schlick_weight(dot(wi, w_h))[None, :])
    g = (smith_shadowing_ggx_aniso(dot(n, wi), torch.abs(dot(wi, tangent)),
                                   torch.abs(dot(wi, bitangent)), ax, ay)
         * smith_shadowing_ggx_aniso(dot(n, wo), torch.abs(dot(wo, tangent)),
                                     torch.abs(dot(wo, bitangent)), ax, ay))
    return f * (d * g)[None, :]


def disney_microfacet_transmission_isotropic(mat, n, wo, wi):
    o_dot_n = dot(wo, n)
    i_dot_n = dot(wi, n)
    degenerate = (o_dot_n == 0.0) | (i_dot_n == 0.0)
    entering = o_dot_n > 0.0
    one = torch.ones_like(o_dot_n)
    eta_o = torch.where(entering, one, mat.ior)
    eta_i = torch.where(entering, mat.ior, one)
    w_h = normalize(wo + wi * (eta_i / eta_o)[None, :], eps=1e-20)

    alpha = torch.clamp(mat.roughness * mat.roughness, min=0.001)
    d = gtr_2(torch.abs(dot(n, w_h)), alpha)
    f = fresnel_dielectric(torch.abs(dot(wi, n)), eta_o, eta_i)
    g = (smith_shadowing_ggx(torch.abs(dot(n, wi)), alpha)
         * smith_shadowing_ggx(torch.abs(dot(n, wo)), alpha))
    i_dot_h = dot(wi, w_h)
    o_dot_h = dot(wo, w_h)
    denom = (eta_o * o_dot_h + eta_i * i_dot_h) ** 2
    c = (torch.abs(o_dot_h) / torch.clamp(torch.abs(o_dot_n), min=1e-20)
         * torch.abs(i_dot_h) / torch.clamp(torch.abs(i_dot_n), min=1e-20)
         * (eta_o * eta_o) / torch.clamp(denom, min=1e-20))
    result = mat.base_color * (c * (1.0 - f) * g * d)[None, :]
    return torch.where(degenerate[None, :], torch.zeros_like(result), result)


def disney_eval(mat, n, wo, wi, tangent, bitangent):
    """Full BRDF evaluation (reference disney_brdf.cuh:193-217)."""
    same = same_hemisphere(wo, wi, n)
    coat = disney_clear_coat(mat, n, wo, wi)
    sheen = disney_sheen(mat, n, wo, wi)
    diffuse = disney_diffuse(mat, n, wo, wi)
    gloss_iso = disney_microfacet_isotropic(mat, n, wo, wi)
    gloss_aniso = disney_microfacet_anisotropic(mat, n, wo, wi, tangent,
                                                bitangent)
    gloss = where3(mat.anisotropy == 0.0, gloss_iso, gloss_aniso)
    refl = ((diffuse + sheen)
            * ((1.0 - mat.metallic)
               * (1.0 - mat.specular_transmission))[None, :]
            + gloss + coat[None, :])

    spec_trans = disney_microfacet_transmission_isotropic(mat, n, wo, wi)
    trans = spec_trans * ((1.0 - mat.metallic)
                          * mat.specular_transmission)[None, :]
    trans = where3(mat.specular_transmission > 0.0, trans,
                   torch.zeros_like(trans))
    return where3(same, refl, trans)


def _frame_from_n(n):
    """up = |n.z| < 0.999 ? z : x; tangent = normalize(cross(up, n))."""
    use_z = torch.abs(n[2]) < 0.999
    zero = torch.zeros_like(n[0])
    one = torch.ones_like(n[0])
    up = torch.stack([torch.where(use_z, zero, one), zero,
                      torch.where(use_z, one, zero)], dim=0)
    tangent = normalize(cross(up, n), eps=1e-20)
    bitangent = cross(n, tangent)
    return tangent, bitangent


def _local_to_world(tangent, bitangent, n, hx, hy, hz):
    return normalize(tangent * hx[None, :] + bitangent * hy[None, :]
                     + n * hz[None, :], eps=1e-20)


def sample_ggx(n, alpha, u1, u2):
    phi = TWO_PI * u1
    cos_theta = torch.sqrt(torch.clamp(
        (1.0 - u2) / (1.0 + (alpha * alpha - 1.0) * u2), min=0.0))
    sin_theta = 1.0 - cos_theta * cos_theta  # reference quirk
    tangent, bitangent = _frame_from_n(n)
    return _local_to_world(tangent, bitangent, n,
                           sin_theta * torch.cos(phi),
                           sin_theta * torch.sin(phi), cos_theta)


def sample_cosine_hemisphere(n, u1, u2):
    phi = TWO_PI * u1
    cos_theta = torch.sqrt(u2)
    sin_theta = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    tangent, bitangent = _frame_from_n(n)
    return _local_to_world(tangent, bitangent, n,
                           sin_theta * torch.cos(phi),
                           sin_theta * torch.sin(phi), cos_theta)


def sample_gtr_1_h(n, tangent, bitangent, alpha, u1, u2):
    phi = TWO_PI * u1
    a2 = alpha * alpha
    cos2 = (1.0 - torch.pow(a2, 1.0 - u2)) / (1.0 - a2)
    cos_theta = torch.sqrt(torch.clamp(cos2, min=0.0))
    sin_theta = 1.0 - cos2  # reference quirk
    return _local_to_world(tangent, bitangent, n,
                           sin_theta * torch.cos(phi),
                           sin_theta * torch.sin(phi), cos_theta)


def sample_gtr_2_aniso_h(n, tangent, bitangent, alpha_x, alpha_y, u1, u2):
    x = TWO_PI * u1
    s = torch.sqrt(torch.clamp(u2 / torch.clamp(1.0 - u2, min=1e-12),
                               min=0.0))
    w_h = (tangent * (alpha_x * torch.cos(x) * s)[None, :]
           + bitangent * (alpha_y * torch.sin(x) * s)[None, :] + n)
    return normalize(w_h, eps=1e-20)


def gtr_1_pdf(wo, wi, n, alpha):
    same = same_hemisphere(wo, wi, n)
    w_h = normalize(wi + wo, eps=1e-20)
    cos_theta_h = dot(n, w_h)
    d = gtr_1(cos_theta_h, alpha)
    pdf = d * cos_theta_h / (4.0 * dot(wo, w_h))
    return torch.where(same, pdf, torch.zeros_like(pdf))


def gtr_2_aniso_pdf(wo, wi, n, tangent, bitangent, alpha_x, alpha_y):
    same = same_hemisphere(wo, wi, n)
    w_h = normalize(wi + wo, eps=1e-20)
    cos_theta_h = torch.abs(dot(n, w_h))
    d = gtr_2_aniso(cos_theta_h, torch.abs(dot(w_h, tangent)),
                    torch.abs(dot(w_h, bitangent)), alpha_x, alpha_y)
    pdf = d * cos_theta_h / (4.0 * torch.abs(dot(wo, w_h)))
    return torch.where(same, pdf, torch.zeros_like(pdf))


def build_tangent_space(normal):
    """NBVH ortho_basis used by the bounce sampler."""
    nx, ny = normal[0], normal[1]
    use_x = (nx < 0.6) & (nx > -0.6)
    use_y = ~use_x & (ny < 0.6) & (ny > -0.6)
    use_z = ~use_x & ~use_y
    b = torch.stack([use_x, use_y, use_z], dim=0).to(normal.dtype)
    tangent = normalize(cross(b, normal), eps=1e-20)
    bitangent = normalize(cross(normal, tangent), eps=1e-20)
    return tangent, bitangent


def disney_pdf_3component(mat, n, wo, wi, tangent, bitangent):
    same = same_hemisphere(wo, wi, n)
    alpha = torch.clamp(mat.roughness * mat.roughness, min=0.001)
    ax, ay = _aniso_alphas(mat)
    cc_alpha = lerp(0.1, 0.001, mat.clearcoat_gloss)

    n_dot_i = torch.clamp(dot(n, wi), min=0.0)
    pdf_diffuse = n_dot_i * INV_PI

    w_h = normalize(wi + wo, eps=1e-20)
    n_dot_h = dot(n, w_h)
    h_dot_o = dot(w_h, wo)
    d_iso = gtr_2(n_dot_h, alpha)
    pdf_spec_iso = d_iso * n_dot_h / (4.0 * h_dot_o)
    pdf_spec_aniso = gtr_2_aniso_pdf(wo, wi, n, tangent, bitangent, ax, ay)
    pdf_specular = torch.where(mat.anisotropy == 0.0, pdf_spec_iso,
                               pdf_spec_aniso)
    pdf_clearcoat = gtr_1_pdf(wo, wi, n, cc_alpha)

    pdf = (pdf_diffuse + pdf_specular + pdf_clearcoat) / 3.0
    return torch.where(same, pdf, torch.zeros_like(pdf))


def disney_sample_3component(mat, n, wo, tangent, bitangent, u1, u2, u3):
    """Uniform 3-way lobe pick (diffuse/specular/clearcoat) with the mixture
    PDF. Returns (wi [3, N], pdf [N]); pdf == 0 marks invalid samples."""
    component = torch.clamp((u3 * 3.0).to(torch.int32), max=2)

    wi_diffuse = sample_cosine_hemisphere(n, u1, u2)

    alpha = torch.clamp(mat.roughness * mat.roughness, min=0.001)
    ax, ay = _aniso_alphas(mat)
    h_iso = sample_ggx(n, alpha, u1, u2)
    h_aniso = sample_gtr_2_aniso_h(n, tangent, bitangent, ax, ay, u1, u2)
    w_h_spec = where3(mat.anisotropy == 0.0, h_iso, h_aniso)
    wi_specular = reflect(-wo, w_h_spec)

    cc_alpha = lerp(0.1, 0.001, mat.clearcoat_gloss)
    w_h_cc = sample_gtr_1_h(n, tangent, bitangent, cc_alpha, u1, u2)
    wi_clearcoat = reflect(-wo, w_h_cc)

    wi = where3(component == 0, wi_diffuse,
                where3(component == 1, wi_specular, wi_clearcoat))

    valid = (component == 0) | same_hemisphere(wo, wi, n)
    valid &= mat.specular_transmission < 1.0

    pdf = disney_pdf_3component(mat, n, wo, wi, tangent, bitangent)
    pdf = torch.where(valid, pdf, torch.zeros_like(pdf))
    return wi, pdf
