"""BENCHMARK.json keeps the contract and every file it names is found."""

import pytest

from harness import manifest


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_manifest_parses_and_keeps_the_contract(man):
    assert manifest.problems(man) == []


def test_names_and_units_use_allowed_characters(man):
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [w["traffic"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert all(manifest.NAME_RE.fullmatch(n) for n in names)
    assert all(manifest.UNIT_RE.fullmatch(m["unit"])
               for m in man["end_to_end"] + man["per_layer"])


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "", "µs", "x" * 65])
def test_bad_names_are_refused(bad):
    assert not manifest.NAME_RE.fullmatch(bad)


def test_problems_sees_a_broken_manifest(man):
    broken = dict(man, run_seconds=90)
    broken["end_to_end"] = [dict(m, unit="tokens per second")
                            for m in man["end_to_end"]]
    found = manifest.problems(broken)
    assert any("run_seconds" in p for p in found)
    assert any("bad unit" in p for p in found)


def test_every_workload_finds_its_files(man):
    for w in man["workloads"]:
        kind = manifest.read_json("traffic", w["traffic"])["kind"]
        assert kind in ("frames", "batches", "train")
        spec = manifest.read_json("cells", w["name"])
        assert spec["limits"] and spec["control"] in ("network_fp8",
                                                      "geometry_bf16")
        assert kind == "train" or spec["check_pixels"] > 0
        assert manifest.config_path(man, w["config"]).endswith(".json")
        for section, kind in (("end_to_end", "end_to_end"),
                              ("per_layer", "layers")):
            for m in manifest.metrics_of(man, section, w["name"]):
                assert callable(manifest.reader(kind, m["name"]).read)


def test_every_cell_reports_setup_another_metric_and_a_layer(man):
    for w in man["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_of(man, "end_to_end",
                                                      w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(man, "per_layer", w["name"])


def test_a_dotted_metric_falls_back_to_its_stem_file(tmp_path):
    layers = tmp_path / "layers"
    layers.mkdir()
    (layers / "trace_ms.py").write_text("def read(tr):\n    return 1\n")
    (layers / "trace_ms.train.py").write_text(
        "def read(tr):\n    return 2\n")
    assert manifest.reader("layers", "trace_ms.view", str(tmp_path)) \
        .read(None) == 1
    assert manifest.reader("layers", "trace_ms.train", str(tmp_path)) \
        .read(None) == 2
    assert not manifest.reader_path("layers", "mfu.view",
                                    str(tmp_path)).endswith("trace_ms.py")
