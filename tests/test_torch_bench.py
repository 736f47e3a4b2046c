"""bench_torch.py, the port's bench entry, on the CPU at a tiny size.

Its last line must carry bench.py's keys (bench.py:279-291) and name the
device it ran on; BENCH_ADDITIONAL_TRIS, which needs the hybrid branch the
port does not have, must exit non-zero. Run in process, with the knobs set
through the environment; the frame is bench.py's at 32x24.
"""

import importlib.util
import json
import os

import torch

# One intra-op thread: the suite runs several pytest workers side by side,
# and PyTorch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "repeats", "min",
              "max"}


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(ROOT, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_prints_bench_py_line(monkeypatch, capsys):
    for key, val in dict(BENCH_DEVICE="cpu", BENCH_SKIP_CPU="1",
                         BENCH_WIDTH="32", BENCH_HEIGHT="24",
                         BENCH_FRAMES="1", BENCH_REPEATS="3").items():
        monkeypatch.setenv(key, val)
    assert _bench().main() == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == BENCH_KEYS
    assert last["metric"] == ("neural render Mrays/s @ 32x24 spp1 b3 lane "
                              "(cpu)")
    assert last["unit"] == "Mrays/s" and last["repeats"] == 3
    assert 0 < last["min"] <= last["value"] <= last["max"]
    assert last["vs_baseline"] == 1.0


def test_bench_refuses_the_hybrid_branch(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_ADDITIONAL_TRIS", "64")
    assert _bench().main() != 0
    assert "hybrid" in capsys.readouterr().err
