"""The port's ablation drivers (scripts/ablate_studio_torch.py,
scripts/ablate_knot_torch.py), scripts/ship_studio_torch.py and
scripts/analyze_studio_error_torch.py on the CPU.

The variant tables equal the JAX drivers' (read with `ast`: the JAX scripts
import nothing of JAX, but are read, not run). Each driver then trains its
shipped variant for one step on a small batch and evaluates it at 16x9 x 1
spp with `--device cpu` (the two drivers side by side, one thread each); the
rows, the checkpoints `evaluate --ckpt` loaded and the studio's images are
shared by the tests below. The studio error analysis prints the JAX
script's report on the same two PNGs, number for number.
"""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, SCRIPTS)

import ablate_knot_torch  # noqa: E402
import ablate_studio_torch  # noqa: E402
import analyze_studio_error_torch  # noqa: E402
import ship_studio_torch  # noqa: E402

# One intra-op thread: the suite runs several pytest workers side by side.
torch.set_num_threads(1)

SHIPPED = {"studio": "s16-12k-b64", "knot": "s16-48k-b16"}


def _jax_assignments(name):
    """The module-level constants of scripts/<name>.py, evaluated from its
    syntax tree."""
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


@pytest.mark.parametrize("module, jax_name", [
    (ablate_studio_torch, "ablate_studio"),
    (ablate_knot_torch, "ablate_knot")])
def test_variants_equal_the_jax_drivers(module, jax_name):
    """The same VARIANTS, and the S=32 rows the JAX driver trains off its
    fused kernel train by autograd (`--fused off`) here."""
    ref = _jax_assignments(jax_name)
    assert module.VARIANTS == ref["VARIANTS"]
    off = ref.get("XLA_PATH_VARIANTS",
                  {v for v in ref["VARIANTS"] if v.startswith("s32")})
    assert module.AUTOGRAD_VARIANTS == set(off)


def test_drivers_import_without_jax():
    """The four scripts import with JAX and the JAX package made
    unimportable."""
    code = ("import sys\n"
            "for name in ('jax', 'neural_renderer_tpu', 'imageio',\n"
            "             'optax'):\n"
            "    sys.modules[name] = None\n"
            f"sys.path.insert(0, {SCRIPTS!r})\n"
            "import ablate_studio_torch, ablate_knot_torch\n"
            "import ship_studio_torch, analyze_studio_error_torch\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """Each driver's shipped variant, one step of 128 segments, evaluated
    at 16x9 x 1 on the CPU; both drivers run at once."""
    base = tmp_path_factory.mktemp("ablate")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for scene, name in SHIPPED.items():
        work = base / scene
        log = base / f"{scene}.jsonl"
        cmd = [sys.executable, os.path.join(SCRIPTS,
                                            f"ablate_{scene}_torch.py"),
               name, "--device", "cpu", "--workdir", str(work),
               "--log", str(log), "--steps", "1", "--batch", "128",
               "--width", "16", "--height", "9", "--total-samples", "1"]
        procs[scene] = (subprocess.Popen(cmd, cwd=ROOT, env=env,
                                         stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), work, log)
    runs = {}
    for scene, (p, work, log) in procs.items():
        out = p.communicate(timeout=300)[0]
        runs[scene] = dict(rc=p.returncode, out=out, work=work, log=log)
    return runs


@pytest.mark.parametrize("scene", sorted(SHIPPED))
def test_driver_trains_and_evaluates_on_the_cpu(driver_runs, scene):
    """The driver exits 0, prints its RESULT row and appends the same row,
    with PSNR and FLIP, to its log; evaluate loaded the run's checkpoint."""
    run = driver_runs[scene]
    assert run["rc"] == 0, run["out"][-3000:]
    rows = [json.loads(line) for line in open(run["log"])]
    assert len(rows) == 1
    row = rows[0]
    printed = re.search(r"^RESULT (.*)$", run["out"], re.M)
    assert printed and json.loads(printed.group(1)) == row
    sublanes, _, _, segs, sched = (ablate_studio_torch if scene == "studio"
                                   else ablate_knot_torch).VARIANTS[
        SHIPPED[scene]]
    assert (row["variant"], row["steps"], row["batch"], row["sublanes"],
            row["segments_per_ray"], row["schedule"], row["device"]) == (
        SHIPPED[scene], 1, 128, sublanes, segs, sched, "cpu")
    assert 0.0 < row["psnr_db"] < 100.0 and 0.0 < row["flip_mean"] <= 1.0
    assert row["final_loss"].startswith("step 1/1 loss=")
    weights = os.path.join(run["work"], "lane_step1.npz")
    assert row["weights"] == weights and os.path.isfile(weights)
    assert os.path.isfile(os.path.join(run["work"], "lane_step1.adam.npz"))
    assert f"Loaded checkpoint: {weights}" in run["out"]
    cfg = json.load(open(os.path.join(run["work"], f"{scene}_var.json")))
    assert cfg["checkpoint_path"] == os.path.join(run["work"], "lane_ckpt",
                                                  "step_1")
    for name in ("ground_truth.png", "neural.png"):
        assert os.path.isfile(os.path.join(run["work"], "eval", name))
    if scene == "studio":
        assert "--no-additional" in run["out"]


def test_ship_studio_copies_the_final_weights(driver_runs, tmp_path,
                                              capsys):
    """ship_studio_torch.py copies the run's final weights (the step count
    its config names), byte for byte, to <dest>/torch_lane_step<N>.npz; a
    missing run returns 1."""
    work = driver_runs["studio"]["work"]
    assert ship_studio_torch.main(["s16-12k-b64", "--workdir", str(work),
                                   "--dest", str(tmp_path)]) == 0
    dst = tmp_path / "torch_lane_step1.npz"
    assert dst.read_bytes() == (work / "lane_step1.npz").read_bytes()
    assert str(dst) in capsys.readouterr().out
    assert ship_studio_torch.main(["s16-12k-b64", "--workdir",
                                   str(tmp_path / "none"), "--dest",
                                   str(tmp_path)]) == 1


def _numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.\d+|-?\d+", text)]


def test_analyze_studio_error_prints_the_jax_report(driver_runs, capsys,
                                                    monkeypatch):
    """On the studio run's two PNGs the port's analysis prints the JAX
    script's report: the same lines, every number within one unit of its
    last printed digit (FLIP on the CPU in each package)."""
    out_dir = str(driver_runs["studio"]["work"] / "eval")
    assert analyze_studio_error_torch.main([out_dir]) == 0
    got = capsys.readouterr().out

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "analyze_studio_error", os.path.join(SCRIPTS,
                                             "analyze_studio_error.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    monkeypatch.setattr(sys, "argv", ["analyze_studio_error.py", out_dir])
    jax_script.main()
    ref = capsys.readouterr().out

    strip = re.compile(r"-?\d+\.\d+|-?\d+")
    assert strip.sub("#", got) == strip.sub("#", ref)
    a, b = _numbers(got), _numbers(ref)
    assert len(a) == len(b) > 20
    tokens = strip.findall(ref)
    for x, y, tok in zip(a, b, tokens):
        unit = 10.0 ** -len(tok.split(".")[1]) if "." in tok else 1.0
        assert abs(x - y) <= unit + 1e-12, (x, y, tok)
    assert np.isfinite(a).all()
