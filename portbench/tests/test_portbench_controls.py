"""The controls of the checks fail them: each reference computed one
precision below the configuration's, or the program with a fault planted,
put in the program's place and judged by the cell's own ``verify`` and
``harness.checks``, reads ``correct`` false.

On the card, every control of each cell at the cell's own size (``cuda``,
three seeds); on the CPU, the extraction cell's fp8 control at a tiny size
(the map-build cell's: ``test_portbench_mapbuild.py``)."""

import pytest
import torch

from portbench import control, harness

import tiny


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    return "cuda"


def test_extract_control_fails_at_a_tiny_size():
    cell = tiny.extract_cell()
    cell.mix.update(height=128, width=160, check_images=2)
    for seed in (1, 2, 3):
        out = control.judge(cell, seed, "cpu", which="fp8")
        assert out["correct"] is False, out
        assert set(out["checks"]) == set(cell.limits)


def test_program_readings_pass_at_a_tiny_size():
    cell = tiny.extract_cell()
    cell.mix.update(height=128, width=160, check_images=2)
    out = control.judge(cell, 2**33 + 9, "cpu", program=True)
    assert out["correct"] is True, out
    assert out["info"]["images_checked"] == 2


def test_serve_control_goes_through_the_drivers_check():
    cell = tiny.serve_cell("robotcar-serve-c1")
    out = control.judge(cell, 2**33 + 7, "cpu", which="tf32")
    assert set(out["checks"]) == set(cell.limits)
    assert out["info"]["requests_checked"] >= cell.mix["check_requests"]
    assert all(c["value"] is not None for c in out["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_control_fails_at_the_cells_size(cuda_device, name):
    cell = harness.resolve(harness.load_manifest(), name)
    for seed in (4000000001, 4000000002, 4000000003):
        for which in control.controls_of(cell).CONTROLS:
            out = control.judge(cell, seed, cuda_device, which=which)
            assert out["correct"] is False, (seed, which, out["checks"])
