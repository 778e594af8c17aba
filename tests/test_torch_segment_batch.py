"""``Segmentor.segment_batch``, mmseg's test pipeline on the device, and its
fused tail (``ops/segment_tail.py``).

On the CPU: the tail's plain version against the step-by-step upsample of
each crop, average, resize back and argmax, at the cell's geometry cut
down and at the full-resolution slide's; ``segment_batch`` and
``logits_batch`` against the plain reference ``portbench/reference/
upernet.py`` on seeded mmseg-named weights (ConvNeXt-T widths, a
64-channel head, crops of 64 every 43 pixels, 96×128 images resized into
(128, 64)): logits in float32 within 1e-4 of their largest magnitude,
labels equal wherever the reference's top-2 margin exceeds 1e-3 of its
logits' standard deviation; ``evaluate`` is ``segment_batch([img])[0]``.
On the card (``cuda``): the kernel against the plain version at the
cell's shapes. This file imports neither JAX nor the JAX package.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.reference import upernet as ref
from portbench.weights_segment import make_state_dict
from sfd2_torch.models import upernet as up
from sfd2_torch.ops import segment_tail as st

torch.set_num_threads(2)

CONFIG = Path(__file__).resolve().parents[1] / "portbench/configs/upernet-convnext-b-ade20k.json"


def tiny_config():
    c = copy.deepcopy(json.loads(CONFIG.read_text()))
    c["backbone"].update(arch="tiny", depths=[3, 3, 9, 3], widths=[96, 192, 384, 768])
    c["decode_head"].update(channels=64)
    c["test_cfg"].update(crop_size=[64, 64], stride=[43, 43])
    c["test_pipeline"].update(img_scale=[128, 64])
    return c


def step_by_step(logits, ys, xs, crop, canvas, region, out, n):
    """Each crop's logits upsampled to the crop, summed on the canvas and
    divided by the count, the region resized to `out`: (averaged logits
    [n, rh, rw, C], labels [n, H, W])."""
    c = logits.shape[-1]
    upc = F.interpolate(logits.permute(0, 3, 1, 2), size=crop, mode="bilinear",
                        align_corners=False).reshape(n, len(ys) * len(xs), c, *crop)
    acc = torch.zeros((n, c, *canvas), device=logits.device)
    cnt = torch.zeros((1, 1, *canvas), device=logits.device)
    k = 0
    for y in ys:
        for x in xs:
            acc[:, :, y:y + crop[0], x:x + crop[1]] += upc[:, k]
            cnt[:, :, y:y + crop[0], x:x + crop[1]] += 1
            k += 1
    avg = (acc / cnt)[:, :, :region[0], :region[1]]
    full = F.interpolate(avg, size=out, mode="bilinear", align_corners=False)
    return avg.permute(0, 2, 3, 1), full.argmax(1), full.topk(2, dim=1).values


# (starts y, starts x, crop, canvas, region, out): the cell's geometry at a
# 64 crop, the full-resolution slide's (crops past a padded canvas), whole mode.
GEOMETRIES = [
    ((0,), (0, 21), (64, 64), (64, 85), (64, 85), (96, 128)),
    ((0, 43, 53), (0, 43, 86, 96), (64, 64), (117, 160), (100, 150), (100, 150)),
    ((0,), (0,), (64, 96), (64, 96), (64, 85), (96, 128)),
]


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_tail_plain_matches_step_by_step(geometry):
    ys, xs, crop, canvas, region, out = geometry
    n = 2
    q = (crop[0] // 4, crop[1] // 4)
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.normal(size=(n * len(ys) * len(xs), *q, 150))
                              .astype(np.float32))
    avg, labels, top2 = step_by_step(logits, ys, xs, crop, canvas, region, out, n)
    got = st.segment_tail(logits, st.tail_plan(out, region, ys, xs, crop, q, "cpu"), n)
    assert got.dtype == torch.uint8 and got.shape == (n, *out)
    sure = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert torch.equal(got.long()[sure], labels[sure])
    folded = st.segment_tail(logits, st.tail_plan(region, region, ys, xs, crop, q, "cpu"), n,
                             labels=False)
    torch.testing.assert_close(folded, avg, rtol=0, atol=2e-6)


def test_axis_weights_fold_at_most_three_taps_and_sum_to_one():
    base, w = st.axis_weights(1600, 683, (0, 171), 512, 128)
    assert base.shape == (1600, 2) and w.shape == (1600, 2, 3)
    np.testing.assert_allclose(w.sum((1, 2)), 1.0, atol=1e-12)
    assert (w >= 0).all() and base.max() <= 127
    assert (w[(base[..., None] + np.arange(3)) > 127] == 0).all()  # no tap past the logits


@pytest.fixture(scope="module")
def tiny_case():
    config = tiny_config()
    state = make_state_dict(config, 2**35 + 1, "cpu")
    model = up.ConvNeXtUPerNet("tiny", head_channels=64, ln_eps=1e-6)
    up.load_mmseg_state_dict(model, state)
    rng = np.random.default_rng(3)
    images = [(rng.random((96, 128, 3)) * 255).astype(np.uint8) for _ in range(2)]
    return config, state, model, images


def test_segment_batch_matches_the_reference(tiny_case):
    config, state, model, images = tiny_case
    seg = up.Segmentor(model, up.SegmentorConfig(crop=64, stride=43, scale=(128, 64)),
                       device="cpu")
    assert seg.plan(96, 128) == ((64, 85), (64, 85), (64, 64), (0,), (0, 21))
    labels = seg.segment_batch(images)
    logits = seg.logits_batch(images)
    assert labels.dtype == np.uint8 and labels.shape == (2, 96, 128)
    assert logits.shape == (2, 64, 85, 150)
    for im, lab, lg in zip(images, labels, logits):
        avg = ref.slide_logits(state, im, config, "cpu")
        ref_labels, margin = ref.labels_and_margin(avg, im.shape[:2])
        torch.testing.assert_close(lg, avg.permute(1, 2, 0), rtol=0,
                                   atol=1e-4 * float(avg.abs().max()))
        sure = margin > 1e-3 * float(avg.std())
        assert sure.float().mean() > 0.95
        assert torch.equal(torch.from_numpy(lab).long()[sure], ref_labels[sure])


def test_evaluate_is_segment_batch_of_one(tiny_case):
    _, _, model, images = tiny_case
    for scale in (None, (128, 64)):
        for mode in ("slide", "whole"):
            seg = up.Segmentor(model, up.SegmentorConfig(crop=64, stride=43, mode=mode,
                                                         scale=scale), device="cpu")
            got = seg.evaluate(images[0])
            assert got.dtype == np.uint8 and got.shape == (96, 128)
            np.testing.assert_array_equal(got, seg.segment_batch(images[:1])[0])
            np.testing.assert_array_equal(got, seg.segment_batch(images)[0])


def test_segment_batch_refuses_mixed_shapes(tiny_case):
    _, _, model, images = tiny_case
    seg = up.Segmentor(model, up.SegmentorConfig(crop=64, stride=43), device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        seg.segment_batch([images[0], images[0][:64]])


def test_rescale_and_slide_follow_mmseg():
    assert up.rescale_size(1200, 1600, (2048, 512)) == (512, 683)
    assert up.rescale_size(96, 128, (128, 64)) == (64, 85)
    assert up.slide_starts(683, 512, 341) == (0, 171)
    assert up.slide_starts(512, 512, 341) == (0,)
    assert up.slide_starts(1600, 512, 341) == (0, 341, 682, 1023, 1088)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Triton kernel has no CPU mode")
    return torch.device("cuda")


# The cell's call (8 images, 683×512 resized, crops at x 0 and 171, labels
# at 1200×1600) and the full-resolution slide of one image (20 crops).
CARD_SHAPES = [
    (8, (0,), (0, 171), (512, 512), (512, 683), (1200, 1600)),
    (1, (0, 341, 682, 704), (0, 341, 682, 1023, 1088), (512, 512), (1200, 1600), (1200, 1600)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_tail_kernel_matches_plain_on_card(cuda_device, shape):
    n, ys, xs, crop, region, out = shape
    q = (crop[0] // 4, crop[1] // 4)
    gen = torch.Generator(cuda_device).manual_seed(5)
    logits = torch.randn((n * len(ys) * len(xs), *q, 150), generator=gen, device=cuda_device)
    plan = st.tail_plan(out, region, ys, xs, crop, q, cuda_device)
    launches = st.segment_tail.launches
    got = st.segment_tail(logits, plan, n)
    torch.cuda.synchronize()
    assert st.segment_tail.launches == launches + 1
    want = st.segment_tail_plain(logits, plan, n, labels=False)
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 1e-4
    assert sure.float().mean() > 0.99
    assert torch.equal(got.long()[sure], want.argmax(-1)[sure])
    half = st.tail_plan(region, region, ys, xs, crop, q, cuda_device)
    folded = st.segment_tail(logits[:len(ys) * len(xs)], half, 1, labels=False)
    torch.testing.assert_close(folded, st.segment_tail_plain(logits[:len(ys) * len(xs)], half, 1,
                                                             labels=False), rtol=0, atol=1e-5)
