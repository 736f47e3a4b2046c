"""Train-then-evaluate runner shared by the PyTorch/CUDA ablation drivers
(scripts/ablate_studio_torch.py, scripts/ablate_knot_torch.py).

One call trains a variant of a scene's lane-grid config through
`python -m neural_renderer_tpu_torch.cli.train`, evaluates the final
checkpoint through `python -m neural_renderer_tpu_torch.cli.evaluate --ckpt`
(480x270, one sample per batch, the config's 64 samples), and appends one
row to a JSON-lines log with the fields of the JAX drivers' rows. Both CLIs
run on the GPU unless `--device cpu` is given, which is passed to both.

A variant's files live in its work dir (default
`<tempdir>/<scene>_ablate_torch_<variant>`): the variant's config
`<scene>_var.json`, the final weights `lane_step<N>.npz` with their
optimizer state `lane_step<N>.adam.npz` (the intermediate checkpoints every
1,000 steps beside them) and the evaluate images under `eval/`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def workdir_for(scene: str, name: str) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"{scene}_ablate_torch_{name}")


def final_weights(workdir: str, steps: int) -> str:
    """The weights the train CLI writes last for `--ckpt-dir
    <workdir>/lane_ckpt` (train/trainer.py::checkpoint_files)."""
    return os.path.join(workdir, f"lane_step{steps}.npz")


def parse_args(argv, variants, scene):
    p = argparse.ArgumentParser(
        description=f"{scene} ablation: train a variant, then evaluate it")
    p.add_argument("variant", choices=sorted(variants))
    p.add_argument("mode", nargs="?", default="both",
                   choices=("both", "train", "eval"))
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, passed to both CLIs")
    p.add_argument("--workdir", default="",
                   help=f"default <tempdir>/{scene}_ablate_torch_<variant>")
    p.add_argument("--log", default=os.path.join(
        tempfile.gettempdir(), f"{scene}_ablation_torch.jsonl"))
    # A run cut below the variant's recipe (tests, smoke runs).
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=270)
    p.add_argument("--total-samples", type=int, default=None)
    return p.parse_args(argv)


def write_variant_config(scene_dir, config_name, workdir, sublanes, steps,
                         scene):
    """The scene's config with the variant's sublanes, its asset paths made
    absolute and its checkpoint_path on the run's final weights."""
    with open(os.path.join(scene_dir, config_name)) as f:
        cfg = json.load(f)
    cfg["neural_network"]["lane_sublanes"] = sublanes
    cfg["checkpoint_path"] = os.path.join(workdir, "lane_ckpt",
                                          f"step_{steps}")
    for v in cfg["scene"].values():
        if isinstance(v, dict) and "path" in v:
            v["path"] = os.path.join(scene_dir, v["path"])
    env = cfg.get("environment", {})
    if env.get("hdri_path"):
        env["hdri_path"] = os.path.join(scene_dir, env["hdri_path"])
    path = os.path.join(workdir, f"{scene}_var.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def run_variant(argv, *, scene, scene_dir, config_name, variants,
                autograd_variants, evaluate_flags=(), log_every=200):
    args = parse_args(argv, variants, scene)
    name = args.variant
    sublanes, steps, batch, segs, sched = variants[name]
    steps = args.steps or steps
    batch = args.batch or batch
    workdir = os.path.abspath(args.workdir or workdir_for(scene, name))
    os.makedirs(workdir, exist_ok=True)
    var_json = write_variant_config(scene_dir, config_name, workdir,
                                    sublanes, steps, scene)
    weights = final_weights(workdir, steps)

    t0 = time.time()
    train_wall = 0.0
    final_loss = ""
    train_cmd = [sys.executable, "-m", "neural_renderer_tpu_torch.cli.train",
                 var_json, "--steps", str(steps), "--batch-size", str(batch),
                 "--segments-per-ray", str(segs), "--lr-schedule", sched,
                 "--ckpt-dir", os.path.join(workdir, "lane_ckpt"),
                 "--log-every", str(log_every), "--device", args.device]
    if name in autograd_variants:
        train_cmd += ["--fused", "off"]
    if args.mode in ("both", "train"):
        print("TRAIN:", " ".join(train_cmd), flush=True)
        r = subprocess.run(train_cmd, cwd=ROOT, capture_output=True,
                           text=True)
        train_wall = time.time() - t0
        print(r.stdout[-2500:], r.stderr[-1500:], flush=True)
        if r.returncode != 0:
            return 1
        with open(os.path.join(workdir, "train.log"), "w") as f:
            f.write(r.stdout)
        loss_lines = re.findall(r"step \d+/\d+ loss=[^\n]*", r.stdout)
        final_loss = loss_lines[-1] if loss_lines else ""
    if args.mode == "train":
        print("train done (eval skipped)", flush=True)
        return 0

    t1 = time.time()
    eval_cmd = [sys.executable, "-m", "neural_renderer_tpu_torch.cli.evaluate",
                var_json, "--width", str(args.width), "--height",
                str(args.height), "--batch-spp", "1", *evaluate_flags,
                "--ckpt", weights, "--output", os.path.join(workdir, "eval"),
                "--device", args.device]
    if args.total_samples:
        eval_cmd += ["--total-samples", str(args.total_samples)]
    print("EVAL:", " ".join(eval_cmd), flush=True)
    r = subprocess.run(eval_cmd, cwd=ROOT, capture_output=True, text=True)
    eval_wall = time.time() - t1
    print(r.stdout[-2000:], r.stderr[-800:], flush=True)
    if r.returncode != 0:
        return 1
    psnr = re.search(r"PSNR: ([0-9.]+) dB", r.stdout)
    flip = re.search(r"FLIP: ([0-9.]+) \(mean\)", r.stdout)
    row = {"variant": name, "sublanes": sublanes, "steps": steps,
           "batch": batch, "segments_per_ray": segs, "schedule": sched,
           "device": args.device,
           "psnr_db": float(psnr.group(1)) if psnr else None,
           "flip_mean": float(flip.group(1)) if flip else None,
           "final_loss": final_loss,
           "train_wall_s": round(train_wall, 1),
           "eval_wall_s": round(eval_wall, 1),
           # batch = SEGMENTS per step (the sampler's batch): do not
           # multiply by segments_per_ray
           "mseg_per_s": round(steps * batch / train_wall / 1e6, 2)
           if train_wall else None,
           "weights": weights}
    with open(args.log, "a") as f:
        f.write(json.dumps(row) + "\n")
    print("RESULT", json.dumps(row), flush=True)
    return 0 if psnr and flip else 1
