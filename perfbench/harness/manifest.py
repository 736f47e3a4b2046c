"""BENCHMARK.json and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by name:

  perfbench/configs/<config>.json        the scene as it is run
  perfbench/traffic/<traffic>.json       the traffic mix's parameters
  perfbench/cells/<workload>.json        a cell's correctness sample and limits
  perfbench/end_to_end/<metric>.py       an end-to-end metric's reader
  perfbench/layers/<metric>.py           a per-layer metric's reader

A metric whose own file is missing is read by the file of its name up to
the last dot: `layers/trace_ms.py` reads `trace_ms.view`, `trace_ms.eval`
and every other `trace_ms.<part>` that has no file of its own.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT_MAX = 200


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload '{name}' in BENCHMARK.json")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration '{name}' in BENCHMARK.json")


def config_path(man: dict, name: str, root: str = ROOT) -> str:
    return os.path.join(root, config_entry(man, name)["file"])


def read_json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    """perfbench/<kind>/<name>.json."""
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def reader_path(kind: str, name: str, bench_dir: str = BENCH_DIR) -> str:
    """perfbench/<kind>/<name>.py, or where that is missing and the name
    holds a dot, the file of the name up to its last dot."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.isfile(path) and "." in name:
        path = os.path.join(bench_dir, kind, f"{name.rsplit('.', 1)[0]}.py")
    return path


def reader(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """The reader of metric `name` (kind "end_to_end" or "layers"), loaded
    from its path: a metric's name may hold dots."""
    path = reader_path(kind, name, bench_dir)
    stem = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{stem.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(man: dict, section: str, workload_name: str) -> list:
    """The entries of `section` ("end_to_end" or "per_layer") that the
    workload reports: those without a `workloads` key and those listing
    it."""
    return [m for m in man[section]
            if workload_name in m.get("workloads", [workload_name])]


def claimed_kernels(bench_dir: str = BENCH_DIR) -> dict:
    """{layer file's name: its KERNELS patterns} over every layer file
    that claims kernels."""
    out = {}
    d = os.path.join(bench_dir, "layers")
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".py"):
            mod = reader("layers", fn[:-3], bench_dir)
            if getattr(mod, "KERNELS", None):
                out[fn[:-3]] = tuple(mod.KERNELS)
    return out


def _text_ok(s) -> bool:
    return (isinstance(s, str) and 1 <= len(s) <= TEXT_MAX
            and "\n" not in s and "\t" not in s)


def problems(man: dict, root: str = ROOT) -> list:
    """What in the manifest breaks the benchmark's contract (names, units,
    texts, references between entries, files); [] when nothing does."""
    out = []

    def name_ok(n, what):
        if not (isinstance(n, str) and NAME_RE.fullmatch(n)):
            out.append(f"bad {what} name {n!r}")

    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(man) != keys:
        out.append(f"keys {sorted(man)} are not {sorted(keys)}")
    for w in man.get("command", []):
        if not _text_ok(w) or w.startswith("/") or ".." in w.split("/"):
            out.append(f"bad command word {w!r}")
    for p in man.get("paths", []):
        if not re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) or ".." in p:
            out.append(f"bad path {p!r}")
    rs = man.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append(f"bad run_seconds {rs!r}")
    cfg_names = set()
    for c in man.get("configs", []):
        name_ok(c.get("name"), "config")
        cfg_names.add(c.get("name"))
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c.get('name')} keys {sorted(c)}")
        for k in ("source", "why"):
            if not _text_ok(c.get(k)):
                out.append(f"config {c.get('name')} bad {k}")
        if not any(c.get("file", "").startswith(p.rstrip("/") + "/")
                   for p in man.get("paths", [])):
            out.append(f"config file {c.get('file')} outside paths")
        elif not os.path.isfile(os.path.join(root, c["file"])):
            out.append(f"config file {c['file']} missing")
        for k in c.get("reduced", []):
            name_ok(k, "reduced key")
    wl_names = set()
    for w in man.get("workloads", []):
        name_ok(w.get("name"), "workload")
        name_ok(w.get("traffic"), "traffic")
        wl_names.add(w.get("name"))
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload {w.get('name')} keys {sorted(w)}")
        if w.get("config") not in cfg_names:
            out.append(f"workload {w.get('name')}: unknown config")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}: chips {w.get('chips')}")
        if not _text_ok(w.get("why")):
            out.append(f"workload {w.get('name')}: bad why")
        for kind, name in (("traffic", w.get("traffic")),
                           ("cells", w.get("name"))):
            if not os.path.isfile(os.path.join(root, "perfbench", kind,
                                               f"{name}.json")):
                out.append(f"missing perfbench/{kind}/{name}.json")
    used = {w.get("config") for w in man.get("workloads", [])}
    for c in cfg_names - used:
        out.append(f"config {c} is used by no workload")
    names = set()
    for section, kind in (("end_to_end", "end_to_end"),
                          ("per_layer", "layers")):
        for m in man.get(section, []):
            name_ok(m.get("name"), "metric")
            if m.get("name") in names:
                out.append(f"metric {m.get('name')} twice")
            names.add(m.get("name"))
            if not (isinstance(m.get("unit"), str)
                    and UNIT_RE.fullmatch(m["unit"])):
                out.append(f"metric {m.get('name')}: bad unit")
            if m.get("better") not in ("lower", "higher"):
                out.append(f"metric {m.get('name')}: bad better")
            for wl in m.get("workloads", []):
                if wl not in wl_names:
                    out.append(f"metric {m.get('name')}: unknown {wl}")
            if not os.path.isfile(reader_path(
                    kind, str(m.get("name")), os.path.join(root,
                                                           "perfbench"))):
                out.append(f"no reader for {m.get('name')} in "
                           f"perfbench/{kind}/")
    e2e = {m["name"]: m for m in man.get("end_to_end", [])}
    for m in man.get("end_to_end", []):
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append(f"metric {m['name']}: bad source")
        if not (isinstance(m.get("bound"), (int, float))
                and 0.01 <= m["bound"] <= 0.25):
            out.append(f"metric {m['name']}: bad bound")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in man.get("per_layer", []):
        if m.get("source") not in ("device_trace", "program_span",
                                   "program_counter", "host_clock"):
            out.append(f"metric {m['name']}: bad source")
        if not _text_ok(m.get("layer")):
            out.append(f"metric {m['name']}: bad layer")
        moved = e2e.get(m.get("moves"))
        if moved is None:
            out.append(f"metric {m['name']}: moves no end-to-end metric")
            continue
        for wl in m.get("workloads", sorted(wl_names)):
            if wl not in moved.get("workloads", [wl]):
                out.append(f"metric {m['name']}: {wl} does not report "
                           f"{moved['name']}")
    for wl in wl_names:
        e = [m for m in man.get("end_to_end", [])
             if wl in m.get("workloads", [wl])]
        if len(e) < 2:
            out.append(f"workload {wl}: needs setup_s and another metric")
        if not metrics_of(man, "per_layer", wl):
            out.append(f"workload {wl}: no per-layer metric")
    return out
