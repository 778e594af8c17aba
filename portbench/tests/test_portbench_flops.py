"""The frozen operation and byte counts against the program's own count
(``sfd2_torch/scripts/bench.py::extract_cost``, a forward on the meta
device), and the roofline arithmetic."""

import pytest
import torch

from portbench import flops


@pytest.mark.parametrize("b,h,w", [(2, 96, 128), (1, 200, 328), (3, 64, 64)])
def test_network_table_equals_the_programs_count(b, h, w):
    from sfd2_torch.models.sfd2 import ResSegNetV2
    from sfd2_torch.scripts.bench import extract_cost

    f, nbytes = extract_cost(ResSegNetV2().to(torch.bfloat16), b, h, w)
    assert flops.network_flops(b, h, w) == f
    assert flops.network_bytes(b, h, w) == nbytes


def test_stem_and_match_counts():
    f, nbytes = flops.stem_cost(1, 64, 64)
    assert f == 2 * (64 * 3 * 9 * 64 * 64 + 64 * 64 * 9 * 32 * 32)
    assert nbytes == 64 * 64 * 3 * 4 + (64 * 3 * 9 + 64 * 64 * 9) * 4 + 32 * 32 * 64 * 2
    f, nbytes = flops.match_cost(4, 8, 16, 32, broadcast=True)
    assert f == 2 * 4 * 8 * 16 * 32
    assert nbytes == (8 * 32 + 4 * 16 * 32) * 4 + 8 + 4 * 16 + 4 * 8 * 8


def test_roofline_share():
    assert flops.roofline_share(495e12, 0.0, 2.0, "tf32") == pytest.approx(50.0)
    assert flops.roofline_share(0.0, 3.35e12, 1.0, "bf16") == pytest.approx(100.0)
    assert flops.roofline_share(1.0, 1.0, 0.0, "bf16") is None
