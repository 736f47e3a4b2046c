"""The plain reference of a training step: the segment sampler, the loss
and AdamW, in float32 with TF32 off.

The sampler draws rays as the renderer's trainer does (origins uniform on
a sphere of 1.5x the outer shell's diagonal around the shell, directions
toward uniform points of the outer box) and marches each ray through up
to `segments` shell segments with literal closest-hit queries: the entry
is the first forward crossing of the outer shell; a segment ends at the
first backward outer crossing or the first inner crossing; the ground
truth is the original mesh's closest hit from the segment's (epsilon-
shifted) entry, present where it lies inside the segment; the next
segment enters at the first forward outer crossing past the exit. The
rows of all segments are concatenated segment by segment and cut to the
batch size. The loss is BCE on presence, L1 on distance, cosine on normal
and L2 on colour, the regression terms over present segments, every term
over valid ones; AdamW is decoupled weight decay, then Adam with bias
correction (eps outside the square root).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .frame import SEGMENT_EPSILON, Scene
from .geometry import ANY, BACKWARD_ONLY, FORWARD_ONLY, MISS, closest_hit
from .vec import P_BASE_B, P_BASE_R, safe_normalize, where3


class Batch(NamedTuple):
    inputs: torch.Tensor    # [12, B]
    presence: torch.Tensor  # [B] 0/1
    distance: torch.Tensor  # [B]
    normal: torch.Tensor    # [3, B]
    color: torch.Tensor     # [3, B]
    valid: torch.Tensor     # [B] bool


def draw_rays(gen: torch.Generator, rays: int, radius: float, omin, inv):
    """The step's rays from the generator: one normal draw [3, rays] for
    the origins, then one uniform draw [3, rays] for the targets."""
    dev = gen.device
    o = torch.randn((3, rays), generator=gen, dtype=torch.float32,
                    device=dev)
    o = o / torch.linalg.vector_norm(o, dim=0, keepdim=True) * radius
    u = torch.rand((3, rays), generator=gen, dtype=torch.float32, device=dev)
    d = omin[:, None] + u / torch.clamp(inv[:, None], min=1e-12) - o
    return o, d / torch.linalg.vector_norm(d, dim=0, keepdim=True)


def sample_batch(scene: Scene, gen, batch: int, segments: int,
                 radius: float) -> Batch:
    rays = -(-batch // segments)
    o, d = draw_rays(gen, rays, radius, scene.outer_min, scene.outer_inv)
    eps = SEGMENT_EPSILON
    t, _, _, _ = closest_hit(scene.outer, o, d, FORWARD_ONLY)
    valid = t < MISS
    entry = o + d * torch.where(valid, t, torch.zeros_like(t))[None, :]
    lo, inv = scene.outer_min[:, None], scene.outer_inv[:, None]
    m = scene.original
    base = scene.row[P_BASE_R:P_BASE_B + 1][:, None].expand(3, rays)
    zero3 = torch.zeros((3, rays), dtype=torch.float32, device=o.device)
    rows = []
    for it in range(segments):
        start = entry + d * eps
        t_out, _, _, _ = closest_hit(scene.outer, start, d, BACKWARD_ONLY,
                                     active=valid)
        exit_t = torch.where(t_out < MISS, t_out,
                             torch.full_like(t_out, eps))
        t_in, _, _, _ = closest_hit(scene.inner, start, d, ANY, active=valid)
        inner_hit = t_in < MISS
        seg_t = torch.where(inner_hit & (t_in < exit_t), t_in, exit_t)
        exit_pos = start + d * seg_t[None, :]
        t_gt, tri, u, v = closest_hit(m, start, d, ANY, active=valid)
        inside = (t_gt < MISS) & (t_gt <= seg_t + eps)
        w = (1.0 - u - v)[None, :]
        nrm = safe_normalize(m.n0[:, tri] * w + m.n1[:, tri] * u[None, :]
                             + m.n2[:, tri] * v[None, :])
        rows.append(Batch(
            torch.cat([(start - lo) * inv, (exit_pos - lo) * inv,
                       (0.5 * (start + exit_pos) - lo) * inv,
                       (d + 1.0) * 0.5], dim=0),
            (valid & inside).to(torch.float32),
            torch.where(inside, t_gt, torch.zeros_like(t_gt)),
            where3(inside, nrm, zero3), where3(inside, base, zero3), valid))
        if it + 1 < segments:
            past = exit_pos + d * eps
            t_re, _, _, _ = closest_hit(scene.outer, past, d, FORWARD_ONLY,
                                        active=valid)
            valid = valid & (t_re < MISS)
            entry = past + d * torch.where(valid, t_re,
                                           torch.zeros_like(t_re))[None, :]
    return Batch(*(torch.cat(xs, dim=-1)[..., :batch] for xs in zip(*rows)))


def loss(outputs, b: Batch):
    valid = b.valid.to(torch.float32)
    pos = valid * b.presence
    n_valid = torch.clamp(valid.sum(), min=1.0)
    n_pos = torch.clamp(pos.sum(), min=1.0)
    x = outputs[0]
    bce = (torch.clamp(x, min=0.0) - x * b.presence
           + torch.log1p(torch.exp(-torch.abs(x))))
    presence = (bce * valid).sum() / n_valid
    distance = (torch.abs(outputs[1] - b.distance) * pos).sum() / n_pos
    pn = outputs[2:5]
    pn = pn / torch.clamp(torch.linalg.vector_norm(pn, dim=0, keepdim=True),
                          min=1e-6)
    normal = ((1.0 - (pn * b.normal).sum(dim=0)) * pos).sum() / n_pos
    color = (((outputs[5:8] - b.color) ** 2).sum(dim=0) * pos).sum() / n_pos
    return presence + distance + 0.5 * normal + 0.5 * color


class AdamW:
    """Decoupled weight decay, then Adam (b1, b2, eps outside the root,
    bias-corrected); lr(t) is the learning rate of update t (0-based)."""

    def __init__(self, params, lr, weight_decay, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params = params
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay, b1,
                                                        b2, eps)
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        lr = self.lr(self.t)
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1.0 - lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))


def cosine_lr(lr: float, steps: int, end_factor: float):
    """The learning rate of update t under a cosine decay to end_factor x
    lr over `steps` updates."""
    def f(t):
        c = min(t, steps)
        return lr * ((1.0 - end_factor) * 0.5
                     * (1.0 + math.cos(math.pi * c / steps)) + end_factor)
    return f
