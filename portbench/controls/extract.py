"""Extract cells (bfloat16 trunk): fp8. The reference network with every
convolution's input and weight rounded to float8 e4m3, one scale per
tensor, and its own keypoint selection. ``program`` judges the program's
own answers of one timed-size call instead: the readings a limit is set
above, many seeds in one process."""

from __future__ import annotations

import collections

import numpy as np

from portbench.controls import full_precision
from portbench.reference.sfd2 import Net
from portbench.scene import sub_seed
from portbench.weights import make_state_dict

Features = collections.namedtuple("Features", "keypoints scores descriptors")


CONTROLS = ("fp8",)


def control(cell, seed: int, device, which: str) -> dict:
    """The compared numbers of the fp8 network's features of the images a check samples."""
    extract = cell.driver()
    knobs, mix = cell.config["extraction"], cell.mix
    state = make_state_dict(seed, device)
    pool_u8 = extract.make_images(mix["pool_images"], mix["height"], mix["width"], seed, device)
    ctrl = Net(state, "fp8")
    idx = np.random.default_rng(sub_seed(seed, 6)).choice(len(pool_u8), mix["check_images"],
                                                           replace=False)
    feats = [Features(*extract.reference_outputs(ctrl, pool_u8[i], knobs,
                                                 knobs["pad_multiple"], device)[1])
             for i in idx]
    del ctrl
    ctx = dict(cell=cell, seed=seed, device=device)
    return extract.verify(ctx, state, pool_u8, {0: (idx, feats)})


def program(cell, seed: int, device) -> dict:
    """The compared numbers of one ``extract_batch`` call of the window's
    size, on the seed's weights and images: a sound run's readings."""
    extract = cell.driver()
    mix = cell.mix
    state = make_state_dict(seed, device)
    pool_u8 = extract.make_images(mix["pool_images"], mix["height"], mix["width"], seed, device)
    idx = np.random.default_rng(sub_seed(seed, 6)).choice(len(pool_u8), mix["batch_images"],
                                                           replace=False)
    extractor = extract.make_extractor(cell, state, device)
    with full_precision(False):  # the program runs with the flags a run's window has
        feats = extractor.extract_batch([pool_u8[i].astype(np.float32) / 255.0 for i in idx])
    del extractor
    ctx = dict(cell=cell, seed=seed, device=device)
    return extract.verify(ctx, state, pool_u8, {0: (idx, feats)})
