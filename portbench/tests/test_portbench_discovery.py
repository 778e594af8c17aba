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
    when it has no reader of its own; without "workloads" it is read in
    exactly the cells that report the end-to-end metric it moves, whatever
    their driver."""
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
    reports = {w["name"]: {m["name"] for m in harness.resolve(manifest, w["name"], root).end_to_end}
               for w in manifest["workloads"]}
    images = [name for name, e2e in reports.items() if "images_per_s" in e2e]
    others = [name for name in reports if name not in images]
    assert images and others
    for name in images:
        cell = harness.resolve(harness.load_manifest(root), name, root)
        assert "images_seen.any" in [m["name"] for m in cell.per_layer]
        ctx = {"images_done": 48, "window_s": 10.0, "height": 1200, "width": 1600}
        assert harness.read_per_layer(cell, ctx)["images_seen.any"]["value"] == 48
    for name in others:
        cell = harness.resolve(harness.load_manifest(root), name, root)
        assert "images_seen.any" not in [m["name"] for m in cell.per_layer]


COUNT_DRIVER = '''"""A tiny driver kind: seeded images through one matmul."""
import time

import torch


def run(ctx):
    mix, seed = ctx["cell"].mix, ctx["seed"]
    gen = torch.Generator().manual_seed(seed)
    images = torch.rand((mix["images"], 8, 8), generator=gen)
    setup_s = time.time() - ctx["t_process"]
    t0, done = time.perf_counter(), 0
    while True:
        out = images @ images.transpose(1, 2)
        done += len(images)
        if time.perf_counter() - t0 >= ctx["seconds"]:
            break
    window_s = time.perf_counter() - t0
    numbers = {"gap": float((out - images @ images.transpose(1, 2)).abs().max())}
    return dict(e2e={"images_per_s": done / window_s, "setup_s": setup_s}, numbers=numbers,
                attempted=done, failed=0, memory_peak_bytes=0,
                layer_ctx={"images_done": done, "window_s": window_s}, trace=None)
'''

COUNT_CONTROL = '''"""The count kind's control: every product off by one."""

CONTROLS = ("off_by_one",)


def control(cell, seed, device, which):
    return {"gap": 1.0}
'''


def test_a_new_driver_kind_is_taken_by_its_own_files(tmp_path):
    """A third driver kind that reports images_per_s, added as new files
    (driver, mix, limits, controls, a per-layer reader) and new manifest
    entries, is found, runs tiny, is judged by ``portbench.control`` and
    passes the manifest's checks, with no existing file under portbench/
    changed."""
    import subprocess
    import sys

    from portbench import control

    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    pkg = root / "portbench"
    (pkg / "drivers/count.py").write_text(COUNT_DRIVER)
    (pkg / "controls/count.py").write_text(COUNT_CONTROL)
    (pkg / "mixes/count-tiny.json").write_text(json.dumps(dict(driver="count", images=4)))
    (pkg / "limits/small-count.json").write_text(json.dumps({"limits": {"gap": 1e-6}}))
    (pkg / "metrics/images_counted.small.py").write_text(
        "def read(ctx):\n    return ctx.get('images_done')\n")
    manifest = harness.load_manifest()
    manifest["workloads"].append(dict(name="small-count", config="sfd2-aachen-v1.1",
                                      traffic="count-tiny", chips=1, why="a test"))
    next(m for m in manifest["end_to_end"]
         if m["name"] == "images_per_s")["workloads"].append("small-count")
    manifest["per_layer"].append(dict(name="images_counted.small", unit="images",
                                      better="higher", source="program_counter", layer="device",
                                      moves="images_per_s", workloads=["small-count"]))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.resolve(harness.load_manifest(root), "small-count", root)
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["images_counted.small"]
    line = tiny.run_line(cell, seconds=0.2)
    assert line["correct"] is True and set(line["metrics"]) == {"images_per_s", "setup_s"}
    line = tiny.run_line(cell, seconds=0.2, trace=True)
    assert line["correct"] is True
    assert line["metrics"]["images_counted.small"]["value"] == line["attempted"]
    assert control.controls_of(cell).CONTROLS == ("off_by_one",)
    judged = control.judge(cell, 7, "cpu", which="off_by_one")
    assert judged["correct"] is False and judged["checks"]["gap"]["value"] == 1.0

    manifest_test = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "portbench/tests/test_portbench_manifest.py"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert manifest_test.returncode == 0, manifest_test.stdout[-3000:]
    assert "test_names_use_allowed_characters[small-count]" in manifest_test.stdout
    after = {p.relative_to(root): p.read_bytes() for p in (root / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
