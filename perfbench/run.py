"""Run one cell of the port's benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: sets up the cell that BENCHMARK.json names
(its configuration, traffic mix and correctness limits, each a file
under perfbench/), warms up every shape the traffic uses, then calls the
renderer in a closed loop with one caller for `--seconds`, counting
whole calls (the window ends at the end of the last call that
completed). `--trace 0` reports the cell's end-to-end metrics, `--trace
1` runs the same window under the profiler and reports its per-layer
metrics; a layer metric read on the host clock (its reader sets
`UNTRACED`) gets an untraced window of the same length first. Then it checks what the timed calls returned against the plain
reference (perfbench/reference/) and prints, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics,
device[, breakdown], and last the numbers compared with their limits
(also the last lines of standard error).

Exits 3 without a result when no CUDA device (or fewer than the cell's
chips) is present, 2 when the program or the manifest is missing, and 4
when a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names that no run may load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "neural_renderer_tpu")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among module names (sys.modules by
    default), each compared whole: `neural_renderer_tpu_torch` is not
    `neural_renderer_tpu`."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def card_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class RowCounter:
    """Counts the rows handed to the network (`models/nbvh.py::apply`, which
    the shell march calls through the module attribute): each call's live
    rows stay on the device and are read once, after the window."""

    def __init__(self):
        from neural_renderer_tpu_torch.models import nbvh
        self.module = nbvh
        self.orig = nbvh.apply
        self.rows = []

        def counting(net, inputs, active=None):
            self.rows.append(inputs.shape[1] if active is None
                             else active.sum())
            return self.orig(net, inputs, active=active)
        nbvh.apply = counting

    def close(self) -> list:
        self.module.apply = self.orig
        return [int(r) for r in self.rows]


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", overrides: dict | None = None,
             t_start: float = T_START, root: str = ROOT):
    """One run of a cell: (result dict, lines for standard output, lines
    for standard error). `overrides`
    replaces keys of the traffic mix ("traffic") and of the cell file
    ("cell"), for tests at a small size."""
    import torch

    from harness import cells, manifest, records
    from harness import trace as tr
    overrides = overrides or {}
    bench_dir = os.path.join(root, "perfbench")
    man = manifest.load(root)
    wl = manifest.workload(man, workload)
    traffic = dict(manifest.read_json("traffic", wl["traffic"], bench_dir),
                   **overrides.get("traffic", {}))
    spec = dict(manifest.read_json("cells", wl["name"], bench_dir),
                **overrides.get("cell", {}))
    cfg_path = manifest.config_path(man, wl["config"], root)

    t_build = time.perf_counter()
    if torch.device(device).type == "cuda":
        # Every library of the program built before the window (once a
        # checkout): one loaded first inside the window, as the march's
        # rare re-traces load theirs, would compile there.
        from neural_renderer_tpu_torch.ops import cuda_build
        cuda_build.build()
    cell = cells.make(cfg_path, traffic, seed, device)
    cell.plan_check(spec, seed)
    t_warm = time.perf_counter()
    for _ in range(int(traffic["warmup_calls"])):
        cell.call()
    _sync(device)
    setup_note = (f"set-up: to the cell {t_build - t_start!r} s, building "
                  f"it {t_warm - t_build!r} s, warm-up "
                  f"{time.perf_counter() - t_warm!r} s")
    setup_s = time.perf_counter() - t_start
    layer_metrics = [
        (m, manifest.reader("layers", m["name"], bench_dir))
        for m in manifest.metrics_of(man, "per_layer", workload)] \
        if trace else []

    first = cell.calls
    untraced = []
    if any(getattr(mod, "UNTRACED", False) for _, mod in layer_metrics):
        # A layer metric read on the host clock comes from a window of
        # its own, ahead of the traced one: the profiler's host cost
        # would lengthen the very calls it times.
        untraced = _window(cell, seconds, first, False)
    counter = recorder = None
    if trace:
        counter = RowCounter()
        recorder = tr.Recorder()
        recorder.start()
    spans = _window(cell, seconds, first, trace)
    n_calls = len(spans)
    if n_calls == 0:
        raise RuntimeError("no call completed in the window")

    traced = None
    if trace:
        host, dev = recorder.stop()
        rows = counter.close()
        marks = [(s, e) for name, s, e in host if name == "perfbench.call"]
        window = (min(s for s, _ in marks), max(e for _, e in marks))
        timeline = tr.Timeline(dev, host, window)
        sizes = dict(cells.network_sizes(cfg_path),
                     work_per_call=cell.work_per_call)
        traced = records.Traced(timeline, [e - b for b, e in spans],
                                {"net_rows": rows}, sizes, {},
                                [e - b for b, e in untraced])
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    if torch.device(device).type == "cuda":
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"

    # The program's state goes before the reference runs.
    t_ref = time.perf_counter()
    numbers = cell.check(cfg_path, spec, device)
    lines_err = [setup_note, f"reference: {cell.check_note}, "
                 f"{time.perf_counter() - t_ref!r} s",
                 "window in fifths, ms a call: " + " ".join(
                     repr(x) for x in _fifths(spans))]
    limits = spec["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)

    lines = []
    metrics = {}
    if trace:
        from harness import peaks as pk
        traced.peaks = pk.peaks(kind) if kind != "cpu" else pk.H100_SXM
        for m, mod in layer_metrics:
            v = mod.read(traced)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        claimed = [p for pats in manifest.claimed_kernels(bench_dir).values()
                   for p in pats]
        for name, s in sorted(tr.seconds_by_name(timeline).items(),
                              key=lambda kv: -kv[1]):
            if not tr.is_library(name) and not any(p in name
                                                   for p in claimed):
                lines.append(f"unclaimed port kernel: {name!r} "
                             f"{s * 1e3 / n_calls!r} device ms a call")
    else:
        run = records.Run([e - b for b, e in spans],
                          spans[-1][1] - spans[0][0], cell.work_per_call,
                          setup_s)
        for m in manifest.metrics_of(man, "end_to_end", workload):
            v = manifest.reader("end_to_end", m["name"], bench_dir).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(correct), "attempted": n_calls + len(untraced),
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if kind != "cpu" else "cpu",
                   "kind": kind,
                   "count": wl["chips"], "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(timeline),
                               "idle_gaps": tr.idle_gaps(timeline)}
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]}
                          for k in limits}
    return result, lines, lines_err


def _window(cell, seconds: float, first: int, mark: bool) -> list:
    """Call the cell in a closed loop for `seconds`, whole calls only:
    each call's (start, end) on the host clock. `mark` names each call
    for the profiler; `first` is the cell's call count when the run's
    first window opened, so `keep` numbers the calls of both windows."""
    import torch
    spans = []
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        t0 = time.perf_counter()
        if mark:
            with torch.autograd.profiler.record_function("perfbench.call"):
                out = cell.call()
        else:
            out = cell.call()
        spans.append((t0, time.perf_counter()))
        cell.keep(cell.calls - 1 - first, out)
    return spans


def _fifths(spans) -> list:
    """Mean ms a call in each fifth of the window's calls (drift shows)."""
    n = len(spans)
    out = []
    for i in range(5):
        part = spans[i * n // 5:(i + 1) * n // 5]
        if part:
            out.append(1e3 * sum(e - b for b, e in part) / len(part))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    # Kernel caches stay inside the checkout, at fixed paths.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH_DIR, ".cache",
                                                  "triton")
    try:
        from harness import manifest
        wl = manifest.workload(manifest.load(ROOT), args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl["chips"]:
        print(f"perfbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import neural_renderer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program is missing: {e}", file=sys.stderr)
        return 2
    result, lines, lines_err = run_cell(args.workload, args.seed,
                                        args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line)
    for line in lines_err:
        print(line, file=sys.stderr)
    print(f"perfbench: {result['device']['kind']}, "
          f"{torch.cuda.device_count()} device(s), card "
          f"{card_power_limit()}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
