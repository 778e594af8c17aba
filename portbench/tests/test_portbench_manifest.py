"""BENCHMARK.json against the benchmark's contract: names, units, keys,
which cells report which metrics, and the files each name points to."""

import json
import re

import pytest

from portbench import harness

MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion",
               "descriptor", "keypoints", "outdim", "experts_per")


def all_names():
    m = MANIFEST
    yield from (c["name"] for c in m["configs"])
    yield from (w["name"] for w in m["workloads"])
    yield from (w["traffic"] for w in m["workloads"])
    yield from (x["name"] for x in m["end_to_end"] + m["per_layer"])
    yield from (k for c in m["configs"] for k in c["reduced"])


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    assert all(not w.startswith("/") and ".." not in w for w in MANIFEST["command"])


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


def test_units_better_sources_and_keys():
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and "\n" not in m["layer"]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in MANIFEST["workloads"]:
        cell = harness.resolve(MANIFEST, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        assert w["chips"] in (1, 4)


def test_per_layer_metrics_move_what_their_cells_report():
    for m in MANIFEST["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in MANIFEST["workloads"]])
        for name in cells:
            reported = {e["name"] for e in harness.resolve(MANIFEST, name).end_to_end}
            assert m["moves"] in reported, (m["name"], name)


def test_every_configuration_keeps_a_cell_and_its_file():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert not any(w in k for k in c["reduced"] for w in WIDTH_WORDS)


def test_unique_names_and_pairs():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in MANIFEST[key]]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_each_name_has_its_files():
    pkg = harness.ROOT / "portbench"
    for w in MANIFEST["workloads"]:
        mix = json.loads((pkg / "mixes" / f"{w['traffic']}.json").read_text())
        assert (pkg / "drivers" / f"{mix['driver']}.py").exists()
        assert (pkg / "limits" / f"{w['name']}.json").exists()
    for m in MANIFEST["per_layer"]:
        assert harness.reader_path(harness.ROOT, m["name"]).exists(), m["name"]
