#!/bin/bash
# Train the shipped networks of the PyTorch/CUDA port from scratch at their
# recipes on the GPU, evaluate each at 480x270 x 64, and copy the weights to
# OUT_DIR (torch_lane_step12000.npz, torch_lane16_step24000.npz,
# torch_weights.bin, torch_lane_step48000.npz: the files under configs/,
# except the lane sphere's, which missed its gate and is not shipped).
#
#   studio       scripts/ablate_studio_torch.py s16-12k-b64 (12,000 x 65,536
#                x 3, cosine; evaluate --no-additional), shipped through
#                scripts/ship_studio_torch.py
#   sphere_lane  configs/sphere/sphere_lane.json, 24,000 x 16,384 x 1, cosine
#                (BASELINE.md:77 gives steps and schedule; the batch is the
#                train CLI's default)
#   sphere       configs/sphere/sphere.json (tcnn), 4,000 x 16,384, constant,
#                the flat FP16 blob (README.md:56-58)
# The studio and knot recipes are the drivers' VARIANTS rows; the two sphere
# recipes have no driver and are written out here only.
#   knot         scripts/ablate_knot_torch.py s16-48k-b16 (48,000 x 16,384 x
#                3, cosine)
#
# Usage (from the repository root):
#   scripts/train_shipped_torch.sh OUT_DIR [studio sphere_lane sphere knot]
# Work dirs go under ${TMPDIR:-/tmp}/train_shipped_torch. Each run prints
# "rc <name> <exit code> wall <seconds>" and the scores evaluate printed. A
# run that fails copies and evaluates nothing, so no earlier run's weights
# land in OUT_DIR under the shipped name.
set -u
OUT=${1:?usage: scripts/train_shipped_torch.sh OUT_DIR [names...]}
shift
NAMES=${*:-studio sphere_lane sphere knot}
WORK=${TMPDIR:-/tmp}/train_shipped_torch
mkdir -p "$OUT" "$WORK"
T="python -m neural_renderer_tpu_torch.cli.train"
E="python -m neural_renderer_tpu_torch.cli.evaluate"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
stamp() { date +%s.%N; }
took() { awk "BEGIN{print $(stamp) - $1}"; }

for name in $NAMES; do
  s=$(stamp)
  case $name in
    studio)
      python scripts/ablate_studio_torch.py s16-12k-b64 \
        --workdir "$WORK/studio" --log "$OUT/studio.jsonl" > "$OUT/studio.log" 2>&1
      rc=$?
      [ $rc -eq 0 ] && python scripts/ship_studio_torch.py s16-12k-b64 \
        --workdir "$WORK/studio" --dest "$OUT" ;;
    sphere_lane)
      $T configs/sphere/sphere_lane.json --steps 24000 --batch-size 16384 \
        --segments-per-ray 1 --lr-schedule cosine --log-every 1000 \
        --ckpt-dir "$WORK/sphere_lane/lane16_ckpt" > "$OUT/sphere_lane.log" 2>&1
      rc=$?
      [ $rc -eq 0 ] && cp "$WORK/sphere_lane/lane16_step24000.npz" \
        "$OUT/torch_lane16_step24000.npz" && \
        $E configs/sphere/sphere_lane.json --width 480 --height 270 \
        --ckpt "$OUT/torch_lane16_step24000.npz" \
        --output "$WORK/sphere_lane/eval" >> "$OUT/sphere_lane.log" 2>&1 ;;
    sphere)
      rm -f "$OUT/torch_weights.bin"
      $T configs/sphere/sphere.json --steps 4000 --batch-size 16384 \
        --log-every 500 --ckpt-dir "$WORK/sphere/tcnn_ckpt" \
        --out "$OUT/torch_weights.bin" > "$OUT/sphere.log" 2>&1
      rc=$?
      [ $rc -eq 0 ] && $E configs/sphere/sphere.json --width 480 --height 270 \
        --ckpt "$OUT/torch_weights.bin" \
        --output "$WORK/sphere/eval" >> "$OUT/sphere.log" 2>&1 ;;
    knot)
      python scripts/ablate_knot_torch.py s16-48k-b16 \
        --workdir "$WORK/knot" --log "$OUT/knot.jsonl" > "$OUT/knot.log" 2>&1
      rc=$?
      [ $rc -eq 0 ] && cp "$WORK/knot/lane_step48000.npz" \
        "$OUT/torch_lane_step48000.npz" ;;
    *) echo "unknown network '$name'" >&2; exit 2 ;;
  esac
  echo "rc $name $rc wall $(took "$s")"
  grep -hE "step [0-9]+/[0-9]+ loss|PSNR:|FLIP: " "$OUT/$name.log" | tail -3
done
