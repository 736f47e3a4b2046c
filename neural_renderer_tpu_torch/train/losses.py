"""Training losses for the shell network.

Port of `neural_renderer_tpu/train/losses.py`: BCE-with-logits on presence
(output row 0), L1 on distance (row 1), cosine on normal (rows 2:5), L2 on
color (rows 5:8). The regression terms are masked to segments whose ground
truth intersects; every term is masked to valid segments.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossWeights(NamedTuple):
    presence: float = 1.0
    distance: float = 1.0
    normal: float = 0.5
    color: float = 0.5


def bce_with_logits(logits, targets):
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(
        torch.exp(-torch.abs(logits)))


def loss_counts(batch):
    """(valid segments, present segments) of a batch, f32 sums: the
    denominators of shell_losses."""
    valid = batch.valid.to(torch.float32)
    return valid.sum(), (valid * batch.presence).sum()


def shell_losses(outputs, batch, weights: LossWeights = LossWeights(),
                 counts=None):
    """outputs: [>=8, B] channel-major network output; batch: SegmentBatch.
    Returns (total, dict of components). `counts` replaces the batch's own
    loss_counts: a data-parallel rank passes the whole batch's, summed
    over the ranks, so the ranks' partial losses add up to the loss of the
    whole batch (as GSPMD's global sums do in the JAX package)."""
    valid = batch.valid.to(torch.float32)
    pos = valid * batch.presence
    n_valid, n_pos = loss_counts(batch) if counts is None else counts
    n_valid = torch.clamp(n_valid, min=1.0)
    n_pos = torch.clamp(n_pos, min=1.0)

    presence_loss = (bce_with_logits(outputs[0], batch.presence)
                     * valid).sum() / n_valid
    dist_loss = (torch.abs(outputs[1] - batch.distance) * pos).sum() / n_pos

    pred_n = outputs[2:5]
    pred_n = pred_n / torch.clamp(
        torch.linalg.vector_norm(pred_n, dim=0, keepdim=True), min=1e-6)
    cos = torch.sum(pred_n * batch.normal, dim=0)
    normal_loss = ((1.0 - cos) * pos).sum() / n_pos

    color_loss = (torch.sum((outputs[5:8] - batch.color) ** 2, dim=0)
                  * pos).sum() / n_pos

    total = (weights.presence * presence_loss + weights.distance * dist_loss
             + weights.normal * normal_loss + weights.color * color_loss)
    return total, {
        "presence": presence_loss,
        "distance": dist_loss,
        "normal": normal_loss,
        "color": color_loss,
        "total": total,
    }
