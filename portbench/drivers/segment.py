"""Segmentation: ``Segmentor.segment_batch`` on batches of seeded images,
through mmseg's ADE20k test pipeline as SFD2's teacher runs it.

Set-up, all from the seed: the configuration's ``SegmentorConfig`` first
(keep-ratio scale, crop and stride, float16 autocast; a program without
``scale`` fails here, at once); UPerNet-ConvNeXt weights by mmseg's names
made on the device (``portbench/weights_segment.py``) and loaded into the
program's ``ConvNeXtUPerNet`` through ``load_mmseg_state_dict``; a pool of
uint8 images of the mix's size (the extraction cell's blocky colour
noise); one call on the first batch.

Window: calls of ``batch_images`` images in a seeded order over the pool
until the window's seconds have passed; a call's uint8 labels are on the
host when it returns. ``images_per_s`` is the images of every finished
call over the time to the last one's end.

Check, once the window has closed: for ``check_images`` of the window's
images drawn from the seed, the program's slide-averaged logits at the
resized scale (``Segmentor.logits_batch``, taken before the program is
freed) and the labels its timed call returned, against the float32
reference (``reference/upernet.py``) on the same weights and image:
``logit_gap`` (max absolute gap over the reference logits' standard
deviation) and ``label_miss_share`` (labels that differ from the
reference's argmax, among pixels whose reference top-2 margin exceeds
``label_margin_std`` standard deviations), each the worst image's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.drivers.extract import make_images
from portbench.reference import upernet as ref
from portbench.scene import sub_seed
from portbench.trace import DeviceTrace, Spans
from portbench.weights_segment import make_state_dict

RECORD_SHARE = 0.05  # share of the window's calls whose labels are kept for the check


def segmentor_config(cell, **overrides):
    """The program's ``SegmentorConfig`` for the cell."""
    from sfd2_torch.models.upernet import SegmentorConfig

    c = cell.config
    (ch, cw), (sh, sw) = c["test_cfg"]["crop_size"], c["test_cfg"]["stride"]
    if ch != cw or sh != sw:
        raise ValueError("the program slides square crops at one stride")
    kw = dict(crop=ch, stride=sh, mode=c["test_cfg"]["mode"],
              scale=tuple(c["test_pipeline"]["img_scale"]), fp16=bool(c["fp16"]))
    kw.update(overrides)
    return SegmentorConfig(**kw)


def make_segmentor(cell, state: dict, device, config):
    """The program's ``Segmentor`` on the configuration's network, loaded
    with `state` by mmseg's names."""
    from sfd2_torch.models.convnext import ARCH_SETTINGS
    from sfd2_torch.models.upernet import ConvNeXtUPerNet, Segmentor, load_mmseg_state_dict

    bb, hd = cell.config["backbone"], cell.config["decode_head"]
    arch = ARCH_SETTINGS[bb["arch"]]
    if list(arch["depths"]) != bb["depths"] or list(arch["channels"]) != bb["widths"]:
        raise ValueError(f"ConvNeXt-{bb['arch']} is not {bb['depths']} × {bb['widths']}")
    with torch.device(device):
        model = ConvNeXtUPerNet(bb["arch"], num_classes=hd["num_classes"],
                                head_channels=hd["channels"], ln_eps=bb["layer_norm_eps"])
    return Segmentor(load_mmseg_state_dict(model, state), config, device=device)


def run(ctx: dict) -> dict:
    cell, seed, seconds, device = ctx["cell"], ctx["seed"], ctx["seconds"], ctx["device"]
    mix = cell.mix
    config = segmentor_config(cell)
    from sfd2_torch.ops.segment_tail import segment_tail

    state = make_state_dict(cell.config, seed, device)
    seg = make_segmentor(cell, state, device, config)
    h, w, b = mix["height"], mix["width"], mix["batch_images"]
    pool = make_images(mix["pool_images"], h, w, seed, device)
    spans = Spans()
    seg.segment_batch(list(pool[:b]))  # every shape of the window, once
    if device != "cpu":
        torch.cuda.synchronize()

    rng = np.random.default_rng(sub_seed(seed, 12))
    kept = {}  # step → (image indices, labels)
    steps = done = 0
    t_start = time.perf_counter()
    setup_s = time.time() - ctx["t_process"]
    t_trace = t_start + seconds * mix["trace_from"] if ctx["trace"] else None
    trace = None
    while True:
        idx = rng.choice(len(pool), b, replace=False)
        if t_trace is not None and trace is None and time.perf_counter() >= t_trace:
            trace, tail_before = DeviceTrace(), segment_tail.shapes.copy()
            t_pause = time.perf_counter()
            trace.start()  # the profiler's start holds the loop for seconds
            paused_s = time.perf_counter() - t_pause
        t0 = time.perf_counter_ns()
        labels = seg.segment_batch([pool[i] for i in idx])
        spans.add("segment.batch", t0, time.perf_counter_ns())
        if rng.random() < RECORD_SHARE or steps == 0:
            kept[steps] = (idx, labels)
        steps += 1
        done += len(labels)
        # The traced part is counted from the trace's own start, after the
        # profiler's start has held the loop.
        if trace is not None and trace.t1 is None and \
                time.perf_counter_ns() >= trace.t0 + seconds * mix["trace_share"] * 1e9:
            trace.stop()
            tail_in_trace = segment_tail.shapes - tail_before
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    if trace is not None and trace.t1 is None:
        trace.stop()
        tail_in_trace = segment_tail.shapes - tail_before
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    sample = sample_images(kept, seed, mix["check_images"])
    images = [pool[kept[s][0][j]] for s, j in sample]
    logits = seg.logits_batch(images)
    del seg
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference runs in full precision
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    numbers = verify(cell, state, device, images, [kept[s][1][j] for s, j in sample], logits)
    numbers["check_s"] = time.perf_counter() - t_check
    layer_ctx = dict(images_done=done, window_s=window_s, height=h, width=w, spans=spans,
                     config=cell.config)
    if trace is not None:
        layer_ctx["window_s"] = window_s - paused_s
        layer_ctx["trace"] = trace.summary(spans)
        layer_ctx["tail_launches"] = dict(tail_in_trace)
    return dict(e2e={"images_per_s": done / window_s, "setup_s": setup_s}, numbers=numbers,
                attempted=done, failed=0, memory_peak_bytes=int(peak), layer_ctx=layer_ctx,
                trace=layer_ctx.get("trace"))


def sample_images(kept: dict, seed: int, n: int) -> list:
    """A seeded sample of (step, slot) among the kept calls."""
    slots = [(s, j) for s in sorted(kept) for j in range(len(kept[s][0]))]
    rng = np.random.default_rng(sub_seed(seed, 13))
    pick = rng.choice(len(slots), min(n, len(slots)), replace=False)
    return [slots[i] for i in sorted(pick)]


def verify(cell, state: dict, device, images, labels, logits) -> dict:
    """The compared numbers of the program's `labels` [H, W] and averaged
    `logits` [rh, rw, classes] (None where it has none at that scale) of
    `images` against the reference's; the worst image's."""
    margin = cell.mix["label_margin_std"]
    gaps, misses, sure = [], [], []
    for im, lab, lg in zip(images, labels, logits):
        avg = ref.slide_logits(state, im, cell.config, device)
        ref_labels, ref_margin = ref.labels_and_margin(avg, im.shape[:2])
        c = ref.compare(lg, lab, avg, ref_labels, ref_margin, margin)
        gaps.append(c["logit_gap"])
        misses.append(c["label_miss_share"])
        sure.append(c["sure_share"])
        del avg, ref_labels, ref_margin
    return dict(logit_gap=None if None in gaps else max(gaps), label_miss_share=max(misses),
                images_checked=len(images), sure_share_least=min(sure))
