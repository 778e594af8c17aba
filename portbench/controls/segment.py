"""Segment cells (float16 autocast): four controls, each the program with a
fault planted, on one call of the window's size from the seed:

* ``bf16``: the forward under bfloat16 autocast, one precision below the
  configuration's float16;
* ``no_resize``: no test-pipeline resize, the full-resolution slide (20
  crops of a 1600×1200 image); its logits are not at the resized scale,
  so ``logit_gap`` has no value there;
* ``stride512``: crops every 512 pixels with none clamped back to the
  far edge, so that no pixel is averaged over two crops;
* ``nearest``: nearest-neighbour in place of bilinear for the resize back
  to the original size.

``program`` judges the program's own answers of the same call instead:
the readings a limit is set above, many seeds in one process."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.controls import full_precision
from portbench.scene import sub_seed
from portbench.weights_segment import make_state_dict

CONTROLS = ("bf16", "no_resize", "stride512", "nearest")


def _unclamped(n: int, crop: int, stride: int) -> tuple:
    """Starts every `stride` pixels, the last running past the far edge."""
    return tuple(range(0, n, stride))


def _nearest(n_out: int, n_in: int):
    """torch's 'nearest' (source ⌊o · n_in / n_out⌋) as taps of weight 1."""
    i0 = np.minimum(np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64), n_in - 1)
    return i0, i0, np.zeros(n_out)


@contextlib.contextmanager
def _swapped(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _judged_call(cell, seed: int, device, which: str | None) -> dict:
    """One ``segment_batch`` call of the window's size, with control
    `which` planted (None: none), and ``logits_batch`` on the checked
    images, judged by the driver's ``verify``."""
    from sfd2_torch.models import upernet
    from sfd2_torch.ops import segment_tail

    seg_driver = cell.driver()
    mix = cell.mix
    overrides = {"no_resize": dict(scale=None),
                 "stride512": dict(stride=cell.config["test_cfg"]["crop_size"][0])}
    config = seg_driver.segmentor_config(cell, **overrides.get(which, {}))
    state = make_state_dict(cell.config, seed, device)
    pool = seg_driver.make_images(mix["pool_images"], mix["height"], mix["width"], seed, device)
    idx = np.random.default_rng(sub_seed(seed, 12)).choice(len(pool), mix["batch_images"],
                                                            replace=False)
    check = sorted(np.random.default_rng(sub_seed(seed, 13)).choice(
        len(idx), min(mix["check_images"], len(idx)), replace=False))
    plants = {"stride512": (upernet, "slide_starts", _unclamped),
              "nearest": (segment_tail, "resize_taps", _nearest)}
    with contextlib.ExitStack() as stack:
        if which in plants:
            stack.enter_context(_swapped(*plants[which]))
        seg = seg_driver.make_segmentor(cell, state, device, config)
        if which == "bf16":
            seg._autocast = torch.bfloat16
        with full_precision(False):  # the program runs with the flags a run's window has
            labels = seg.segment_batch([pool[i] for i in idx])
            images = [pool[idx[j]] for j in check]
            logits = seg.logits_batch(images)
    del seg
    if device != "cpu":
        torch.cuda.empty_cache()
    return seg_driver.verify(cell, state, device, images, [labels[j] for j in check], logits)


def control(cell, seed: int, device, which: str) -> dict:
    """The compared numbers of control `which` on the seed's call."""
    if which not in CONTROLS:
        raise ValueError(f"unknown control {which!r}; known: {CONTROLS}")
    return _judged_call(cell, seed, device, which)


def program(cell, seed: int, device) -> dict:
    """The compared numbers of the program's own call: a sound run's readings."""
    return _judged_call(cell, seed, device, None)
