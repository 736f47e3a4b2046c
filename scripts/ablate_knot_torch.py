#!/usr/bin/env python
"""Knot ablation driver on an NVIDIA GPU: the PyTorch/CUDA port of
scripts/ablate_knot.py, with its variants.

For each variant: train the lane-grid network on the knot scene through
`neural_renderer_tpu_torch.cli.train`, then evaluate the final weights
(GT vs neural, 480x270 x 64 spp) and append one result row to
<tempdir>/knot_ablation_torch.jsonl (scripts/ablate_torch.py). The shipped
network is `s16-48k-b16`.

Usage: python scripts/ablate_knot_torch.py VARIANT [train|eval|both]
         [--device cuda|cpu --workdir DIR --log FILE]
         [--steps N --batch N --width W --height H --total-samples N]
         (a run cut below the recipe)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ablate_torch import ROOT, run_variant  # noqa: E402

KNOT = os.path.join(ROOT, "configs", "knot")

VARIANTS = {
    # name: (sublanes, steps, batch, segments_per_ray, lr_schedule)
    "s16-24k-b16": (16, 24000, 16384, 3, "cosine"),
    "s16-48k-b16": (16, 48000, 16384, 3, "cosine"),   # shipped
    "s16-24k-b64": (16, 24000, 65536, 3, "cosine"),
    "s16-48k-b64": (16, 48000, 65536, 3, "cosine"),
    "s32-24k-b16": (32, 24000, 16384, 3, "cosine"),
    "s32-48k-b16": (32, 48000, 16384, 3, "cosine"),
    "s16-24k-s5": (16, 24000, 16384, 5, "cosine"),
}

# The S=32 rows train by autograd through the plain PyTorch forward
# (`--fused off`), as the JAX driver trains them off its fused kernel.
AUTOGRAD_VARIANTS = {v for v in VARIANTS if v.startswith("s32")}


def main(argv=None) -> int:
    return run_variant(argv, scene="knot", scene_dir=KNOT,
                       config_name="knot_lane.json", variants=VARIANTS,
                       autograd_variants=AUTOGRAD_VARIANTS, log_every=1000)


if __name__ == "__main__":
    sys.exit(main())
