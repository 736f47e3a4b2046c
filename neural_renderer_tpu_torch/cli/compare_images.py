"""compare_images CLI: PSNR and FLIP between two images.

Port of `neural_renderer_tpu/cli/compare_images.py`, same contract: load two
PNG or JPEG images, refuse them (rc 1) when their sizes differ, use the test
image flipped vertically when that raises the PSNR by more than 3 dB, print
PSNR and mean/max FLIP, and optionally save the FLIP error map. FLIP runs on
the GPU unless `--device cpu` is given.

Usage: python -m neural_renderer_tpu_torch.cli.compare_images <ref> <test>
       [flip.png] [--device cuda|cpu]
"""

from __future__ import annotations

import sys


def _split_device(argv: list[str]) -> tuple[list[str], str]:
    """(positional arguments, the --device value or "cuda")."""
    rest, device, i = [], "cuda", 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
            i += 2
            continue
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
        i += 1
    return rest, device


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    argv, device = _split_device(argv)
    if len(argv) < 2:
        print("Usage: compare_images <reference_image> <test_image> "
              "[flip_output.png]", file=sys.stderr)
        print("  Computes PSNR and FLIP metrics between two images.",
              file=sys.stderr)
        print("  Optionally saves FLIP error visualization to third argument.",
              file=sys.stderr)
        print("  --device cpu computes FLIP on the CPU (default: cuda).",
              file=sys.stderr)
        return 1

    import torch
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("compare_images: no CUDA device found; FLIP runs on the GPU "
              "(pass --device cpu to run it on the CPU)", file=sys.stderr)
        return 1

    from ..metrics import compute_flip, compute_psnr, load_image

    ref_path, test_path = argv[0], argv[1]
    flip_output = argv[2] if len(argv) >= 3 else None

    print("=== Image Comparison Tool ===")
    print(f"Reference: {ref_path}")
    print(f"Test:      {test_path}")

    ref = load_image(ref_path)
    print(f"Loaded reference: {ref.shape[1]}x{ref.shape[0]}")
    test = load_image(test_path)
    print(f"Loaded test:      {test.shape[1]}x{test.shape[0]}")

    if ref.shape != test.shape:
        print("Error: Image dimensions do not match!", file=sys.stderr)
        print(f"  Reference: {ref.shape[1]}x{ref.shape[0]}", file=sys.stderr)
        print(f"  Test:      {test.shape[1]}x{test.shape[0]}", file=sys.stderr)
        return 1

    psnr_no_flip = compute_psnr(ref, test)
    test_flipped = test[::-1].copy()
    psnr_flip_y = compute_psnr(ref, test_flipped)
    if psnr_flip_y > psnr_no_flip + 3.0:
        test = test_flipped
        print(f"Detected Y-flipped test image (PSNR {psnr_no_flip:.2f} -> "
              f"{psnr_flip_y:.2f} dB). Using flipped orientation.")

    print("\n=== Computing Metrics ===")
    psnr = compute_psnr(ref, test)
    print(f"PSNR: {psnr:.2f} dB")

    mean_err, max_err = compute_flip(ref, test, output_path=flip_output,
                                     device=device)
    print(f"FLIP max error: {max_err:.4f}")
    print(f"FLIP: {mean_err:.4f} (mean)")
    print("\nComparison complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
