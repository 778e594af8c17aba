"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and new manifest entries are found by name, with no existing
file edited."""

import json
import shutil

from portbench import harness

import tiny


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = harness.load_manifest()
    before = {p.relative_to(root): p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}

    conf = json.loads((root / "portbench/configs/sfd2-aachen-v1.1.json").read_text())
    conf.update(name="sfd2-small-test")
    conf["extraction"].update(max_keypoints=32)
    (root / "portbench/configs/sfd2-small-test.json").write_text(json.dumps(conf))
    (root / "portbench/mixes/extract-tiny.json").write_text(json.dumps(dict(
        driver="extract", batch_images=2, height=64, width=96, pool_images=2, check_images=1,
        trace_from=0.3, trace_share=0.3)))
    (root / "portbench/limits/small-extract.json").write_text(json.dumps(
        {"limits": {"desc_gap": 0.04, "kp_miss_share": 0.08}}))
    (root / "portbench/metrics/images_done.small.py").write_text(
        "def read(ctx):\n    return ctx.get('images_done')\n")
    manifest["configs"].append(dict(name="sfd2-small-test", source="a test",
                                    file="portbench/configs/sfd2-small-test.json", reduced=[],
                                    why="a test"))
    manifest["workloads"].append(dict(name="small-extract", config="sfd2-small-test",
                                      traffic="extract-tiny", chips=1, why="a test"))
    manifest["per_layer"].append(dict(name="images_done.small", unit="images", better="higher",
                                      source="program_counter", layer="device",
                                      moves="images_per_s", workloads=["small-extract"]))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.resolve(harness.load_manifest(root), "small-extract", root)
    assert cell.config["extraction"]["max_keypoints"] == 32
    assert cell.mix["height"] == 64 and set(cell.limits) == {"desc_gap", "kp_miss_share"}
    assert [m["name"] for m in cell.per_layer] == ["images_done.small"]
    cell.config["extraction"]["bf16"] = False
    line = tiny.run_line(cell, seconds=1.0, trace=True)
    assert line["correct"] is True
    assert line["metrics"]["images_done.small"]["value"] == line["attempted"]
    after = {p.relative_to(root): p.read_bytes() for p in (root / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


def test_a_reader_serves_every_metric_of_its_prefix_and_cells_without_a_list(tmp_path):
    """A per-layer metric named <prefix>.<cells> is read by metrics/<prefix>.py
    when it has no reader of its own; without "workloads" it is read in every
    cell that reports the end-to-end metric it moves."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = harness.load_manifest()
    (root / "portbench/metrics/images_seen.py").write_text(
        "def read(ctx):\n    return ctx.get('images_done')\n")
    manifest["per_layer"].append(dict(name="images_seen.any", unit="images", better="higher",
                                      source="program_counter", layer="device",
                                      moves="images_per_s"))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    assert harness.reader_path(root, "images_seen.any").name == "images_seen.py"
    extract = [w["name"] for w in manifest["workloads"]
               if json.loads((root / "portbench/mixes" / f"{w['traffic']}.json").read_text())
               ["driver"] == "extract"]
    serve = [w["name"] for w in manifest["workloads"] if w["name"] not in extract]
    for name in extract:
        cell = harness.resolve(harness.load_manifest(root), name, root)
        assert "images_seen.any" in [m["name"] for m in cell.per_layer]
        ctx = {"images_done": 48, "window_s": 10.0, "height": 1200, "width": 1600}
        assert harness.read_per_layer(cell, ctx)["images_seen.any"]["value"] == 48
    for name in serve:
        cell = harness.resolve(harness.load_manifest(root), name, root)
        assert "images_seen.any" not in [m["name"] for m in cell.per_layer]
