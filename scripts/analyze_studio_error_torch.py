"""Where does the studio GT-vs-neural error live? The PyTorch port of
scripts/analyze_studio_error.py, with the same report.

Reads an evaluate output dir (ground_truth.png + neural.png from
`neural_renderer_tpu_torch.cli.evaluate`) through the port's PNG / JPEG
reader, recomputes FLIP on the CPU through the port's metrics/flip.py, and
reports how the error mass distributes: percentiles, the top-decile share,
and region splits (image thirds; the torus occupies the center, the
normal-mapped half is the +x side of the frame in the studio camera).
Names whether residual error is diffuse (capacity-limited everywhere) or
concentrated (a specific feature binds).

Usage: python scripts/analyze_studio_error_torch.py [comparison_output]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neural_renderer_tpu_torch.metrics import (  # noqa: E402
    compute_flip_map, compute_psnr, load_image)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "comparison_output"
    gt = load_image(os.path.join(out, "ground_truth.png"))[..., :3]
    ne = load_image(os.path.join(out, "neural.png"))[..., :3]

    psnr = float(compute_psnr(gt, ne))
    fmap = compute_flip_map(gt.astype(np.float32) / 255.0,
                            ne.astype(np.float32) / 255.0,
                            device="cpu").numpy()

    flat = np.sort(fmap.ravel())[::-1]
    total = flat.sum()
    n = flat.size
    print(f"PSNR {psnr:.2f} dB | FLIP mean {fmap.mean():.4f} "
          f"max {fmap.max():.4f}")
    print(f"FLIP percentiles: p50 {np.percentile(fmap, 50):.4f}  "
          f"p90 {np.percentile(fmap, 90):.4f}  "
          f"p99 {np.percentile(fmap, 99):.4f}")
    for frac in (0.01, 0.1, 0.25):
        k = int(n * frac)
        print(f"top {frac:4.0%} pixels carry {flat[:k].sum() / total:5.1%} "
              f"of the FLIP mass")

    # Region splits: horizontal thirds and vertical halves.
    thirds = np.array_split(fmap, 3, axis=1)
    print("FLIP mean by horizontal third (L/C/R):",
          "  ".join(f"{t.mean():.4f}" for t in thirds))
    halves = np.array_split(fmap, 2, axis=0)
    print("FLIP mean by vertical half (top/bottom):",
          "  ".join(f"{t.mean():.4f}" for t in halves))

    # Object-vs-background proxy: pixels where GT differs appreciably from
    # the GT border median (the env-dominated background).
    border = np.concatenate([gt[0].ravel(), gt[-1].ravel(),
                             gt[:, 0].ravel(), gt[:, -1].ravel()])
    bg = np.median(border.reshape(-1, 3), axis=0)
    dist = np.abs(gt.astype(np.int32) - bg[None, None]).sum(axis=2)
    obj = dist > 40
    print(f"object mask {obj.mean():5.1%} of frame; FLIP mean on-object "
          f"{fmap[obj].mean():.4f} vs background {fmap[~obj].mean():.4f}; "
          f"object carries {fmap[obj].sum() / total:5.1%} of the mass")

    # Luminance-error correlation: is the residual mostly albedo/shading
    # (low-frequency) or edge/geometry (gradient-aligned)?
    gy, gx = np.gradient(gt.astype(np.float32).mean(axis=2))
    gmag = np.hypot(gx, gy)
    edge = gmag > np.percentile(gmag, 90)
    print(f"GT-edge pixels (top-decile gradient) carry "
          f"{fmap[edge].sum() / total:5.1%} of the FLIP mass "
          f"({edge.mean():4.1%} of pixels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
