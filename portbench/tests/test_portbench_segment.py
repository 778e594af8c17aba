"""The segment cell on the CPU at a tiny size: ConvNeXt-T widths with a
64-channel head, crops of 64 every 43 pixels, 96×128 images resized into
(128, 64), i.e. to 64×85 and 2 crops, as the cell's 1600×1200 images go
to 683×512 and 2 crops. The driver prints the contract line, traced and
not; each of the four controls, planted in the program, reads ``correct``
false; the program's own readings pass."""

import copy

import pytest
import torch

from portbench import control, harness

import tiny

torch.set_num_threads(2)

NAME = "aachen-segment-r1600"


def segment_cell():
    cell = harness.resolve(harness.load_manifest(), NAME)
    cell.config = copy.deepcopy(cell.config)
    cell.config["backbone"].update(arch="tiny", depths=[3, 3, 9, 3], widths=[96, 192, 384, 768])
    cell.config["decode_head"].update(channels=64)
    cell.config["test_cfg"].update(crop_size=[64, 64], stride=[43, 43])
    cell.config["test_pipeline"].update(img_scale=[128, 64])
    cell.mix = dict(cell.mix, height=96, width=128, batch_images=2, pool_images=4,
                    check_images=2)
    return cell


def test_segment_driver_prints_the_line():
    cell = segment_cell()
    line = tiny.run_line(cell, seconds=1.0)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == {"logit_gap", "label_miss_share"}
    assert line["info"]["images_checked"] == 2


def test_segment_driver_traced_reads_the_program_spans():
    cell = segment_cell()
    # Trace most of the window, so that whole calls open and close inside
    # it on a loaded CPU.
    cell.mix.update(trace_from=0.05, trace_share=0.9)
    line = tiny.run_line(cell, seconds=6.0, trace=True)
    assert line["correct"] is True
    got = line["metrics"]
    spans = {f"{n}_ms.segment" for n in ("upload", "prep", "forward", "fuse", "fetch")}
    assert spans | {"mfu.segment"} <= set(got), got
    assert all(got[n]["value"] > 0 for n in spans)
    assert "fuse_roofline.segment" not in got  # the plain version: no kernel in the trace


@pytest.mark.parametrize("which", ["bf16", "no_resize", "stride512", "nearest"])
def test_each_control_reads_false(which):
    cell = segment_cell()
    out = control.judge(cell, 2**33 + 11, "cpu", which=which)
    assert out["correct"] is False, out
    assert set(out["checks"]) == set(cell.limits)


def test_program_readings_pass():
    cell = segment_cell()
    out = control.judge(cell, 2**33 + 11, "cpu", program=True)
    assert out["correct"] is True, out
    assert out["info"]["images_checked"] == 2


def test_reference_loads_no_program_and_no_jax():
    import json
    import subprocess
    import sys

    code = ("import json, sys\n"
            "import portbench.reference.upernet, portbench.weights_segment, "
            "portbench.flops_segment\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    names = set(json.loads(out.strip().splitlines()[-1]))
    assert not names & {"sfd2_torch", "sfd2_tpu", "jax", "jaxlib", "flax"}
