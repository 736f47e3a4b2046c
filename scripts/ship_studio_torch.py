#!/usr/bin/env python
"""Ship a studio ablation run of the PyTorch/CUDA port: copy a variant's
final weights (scripts/ablate_studio_torch.py; the run's config in its
work dir names them) to configs/studio/torch_lane_step<N>.npz. The config
is left as it is: render the copy with `evaluate
configs/studio/studio_lane.json --ckpt <file>`.

Usage: python scripts/ship_studio_torch.py VARIANT [--workdir DIR]
         [--dest DIR]
"""

import argparse
import json
import os
import re
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ablate_studio_torch import STUDIO, VARIANTS  # noqa: E402
from ablate_torch import final_weights, workdir_for  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("variant", choices=sorted(VARIANTS))
    p.add_argument("--workdir", default="",
                   help="the ablation's work dir (default its own)")
    p.add_argument("--dest", default=STUDIO)
    args = p.parse_args(argv)
    workdir = args.workdir or workdir_for("studio", args.variant)
    try:
        with open(os.path.join(workdir, "studio_var.json")) as f:
            ckpt = json.load(f)["checkpoint_path"]
        steps = int(re.search(r"step_(\d+)$", ckpt).group(1))
    except (OSError, KeyError, AttributeError) as e:
        print(f"ship_studio_torch: no run of {args.variant} in {workdir} "
              f"({e!r})", file=sys.stderr)
        return 1
    src = final_weights(workdir, steps)
    if not os.path.isfile(src):
        print(f"ship_studio_torch: no weights at {src}", file=sys.stderr)
        return 1
    dst = os.path.join(args.dest, f"torch_lane_step{steps}.npz")
    shutil.copyfile(src, dst)
    print(f"shipped {args.variant}: {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
