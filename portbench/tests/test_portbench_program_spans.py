"""The readers of the program's own spans (``portbench/program_spans.py``):
a tiny traced run of a serve cell and of the extraction cell on the CPU
prints every metric of its cell that reads them."""

import json

from portbench import harness

import tiny

MANIFEST = harness.load_manifest()


def program_metrics(cell):
    return {m["name"] for m in cell.per_layer
            if "program_spans" in harness.reader_path(harness.ROOT, m["name"]).read_text()}


def test_serve_cell_prints_every_program_span_metric():
    cell = tiny.serve_cell()
    # The profiler slows the CPU's many small LM ops: trace most of the
    # window, so that requests open and close inside it.
    cell.mix = dict(cell.mix, trace_from=0.05, trace_share=0.9)
    names = program_metrics(cell)
    assert len(names) == 11
    line = tiny.run_line(cell, seconds=8.0, trace=True)
    assert line["correct"] is True
    got = line["metrics"]
    assert names <= set(got), sorted(names - set(got))
    assert got["graph_captures.query"]["value"] == 0
    assert 0 <= got["bank_miss_share.query"]["value"] <= 100
    assert all(got[n]["value"] >= 0 for n in names)


def test_extract_cell_prints_every_program_span_metric():
    cell = tiny.extract_cell()
    names = program_metrics(cell)
    assert names == {"round_ms.extract", "upload_ms.extract", "launch_ms.extract",
                     "fetch_ms.extract"}
    line = tiny.run_line(cell, seconds=3.0, trace=True)
    assert line["correct"] is True
    assert names <= set(line["metrics"]), line["metrics"]
    assert all(line["metrics"][n]["value"] > 0 for n in names)


def test_readers_find_nothing_without_a_window():
    """A context without the run's window or spans (and so a program that
    records none) gives no value, and no reader raises."""
    for w in MANIFEST["workloads"]:
        cell = harness.resolve(MANIFEST, w["name"])
        got = harness.read_per_layer(cell, {"requests": [], "images_done": 0, "window_s": 1.0})
        assert not set(got) & program_metrics(cell), json.dumps(got)
