#!/usr/bin/env python
"""Studio ablation driver on an NVIDIA GPU: the PyTorch/CUDA port of
scripts/ablate_studio.py, with its variants.

For each variant: train the lane-grid network on the studio scene through
`neural_renderer_tpu_torch.cli.train`, then evaluate the final weights
(GT vs neural, --no-additional, 480x270 x 64 spp) and append one result row
to <tempdir>/studio_ablation_torch.jsonl (scripts/ablate_torch.py). The
shipped network is `s16-12k-b64`; scripts/ship_studio_torch.py copies a
variant's weights into configs/studio.

Usage: python scripts/ablate_studio_torch.py VARIANT [train|eval|both]
         [--device cuda|cpu --workdir DIR --log FILE]
         [--steps N --batch N --width W --height H --total-samples N]
         (a run cut below the recipe)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ablate_torch import ROOT, run_variant  # noqa: E402

STUDIO = os.path.join(ROOT, "configs", "studio")

VARIANTS = {
    # name: (sublanes, steps, batch, segments_per_ray, lr_schedule)
    "s16-4k": (16, 4000, 262144, 3, "cosine"),
    "s32-4k": (32, 4000, 262144, 3, "cosine"),
    "s32-12k": (32, 12000, 262144, 3, "cosine"),
    "s16-24k": (16, 24000, 262144, 3, "cosine"),
    "s32-24k": (32, 24000, 262144, 3, "cosine"),
    # smaller batch, more Adam steps at ~equal segment count
    "s16-12k-b64": (16, 12000, 65536, 3, "cosine"),
    "s32-12k-b64": (32, 12000, 65536, 3, "cosine"),
    "s16-24k-b64": (16, 24000, 65536, 3, "cosine"),
    "s32-24k-b64": (32, 24000, 65536, 3, "cosine"),
    "s32-24k-b32": (32, 24000, 32768, 3, "cosine"),
    "s32-48k-b32": (32, 48000, 32768, 3, "cosine"),
}

# The S=32 rows train by autograd through the plain PyTorch forward
# (`--fused off`), as the JAX driver trains them off its fused kernel.
AUTOGRAD_VARIANTS = {"s32-4k", "s32-12k", "s32-24k", "s32-12k-b64",
                     "s32-24k-b64", "s32-24k-b32", "s32-48k-b32"}


def main(argv=None) -> int:
    return run_variant(argv, scene="studio", scene_dir=STUDIO,
                       config_name="studio_lane.json", variants=VARIANTS,
                       autograd_variants=AUTOGRAD_VARIANTS,
                       evaluate_flags=("--no-additional",), log_every=200)


if __name__ == "__main__":
    sys.exit(main())
