"""DB extraction: ``Extractor.extract_batch`` on batches of seeded images.

Set-up, all from the seed: ResSegNetV2's weights made on the device
(``portbench/weights.py``); an ``Extractor`` with the configuration's
preset (K1 stem, bf16 trunk, keypoint selection); a pool of images of the
mix's size, blocky colour noise at three scales quantised to uint8
levels and handed over as float32 in [0, 1], as ``load_image`` returns
them; one call on the first batch.

Window: calls of ``batch_images`` images in a seeded order over the pool
until the window's seconds have passed; a call's features are on the
host when it returns. ``images_per_s`` is the images of every finished
call over the time to the last one's end.

Check, once the window has closed and the extractor is freed: for a
sample of the window's images drawn from the seed, the program's
keypoints, scores and descriptors against the float32 reference network
(``reference/sfd2.py``) on the same weights and the same image:
``desc_gap``, ``score_logit_gap`` and ``kp_miss_share``, each the worst
image's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.reference.sfd2 import Net, compare, keypoints, normalise
from portbench.scene import sub_seed
from portbench.trace import DeviceTrace, Spans
from portbench.weights import make_state_dict

RECORD_SHARE = 0.1  # share of the window's calls whose features are kept for the check


def make_images(n: int, h: int, w: int, seed: int, device) -> np.ndarray:
    """uint8 [n, h, w, 3]: blocky colour noise at cells of 64, 16 and 4
    pixels, weights 0.5, 0.3, 0.2, drawn on the device."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(sub_seed(seed, 5))
    img = torch.zeros((n, h, w, 3), device=dev)
    for cell, wgt in ((64, 0.5), (16, 0.3), (4, 0.2)):
        base = torch.rand((n, -(-h // cell), -(-w // cell), 3), generator=gen, device=dev)
        img += wgt * base.repeat_interleave(cell, 1).repeat_interleave(cell, 2)[:, :h, :w]
    return torch.round(img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()


def make_extractor(cell, state: dict, device):
    """The program's ``Extractor`` with the configuration's preset and the
    mix's batch."""
    from sfd2_torch.pipeline.extract import ExtractionConfig, Extractor

    ex_cfg = cell.config["extraction"]
    return Extractor(state, ExtractionConfig(
        max_keypoints=ex_cfg["max_keypoints"], conf_threshold=ex_cfg["conf_threshold"],
        nms_radius=ex_cfg["nms_radius"], border=ex_cfg["border"],
        resize_max=ex_cfg["resize_max"], scales=tuple(ex_cfg["scales"]),
        pad_multiple=ex_cfg["pad_multiple"], batch_size=cell.mix["batch_images"],
        bf16=ex_cfg["bf16"], as_half=ex_cfg["as_half"]), device=device)


def run(ctx: dict) -> dict:
    cell, seed, seconds, device = ctx["cell"], ctx["seed"], ctx["seconds"], ctx["device"]
    mix = cell.mix
    from sfd2_torch.ops.cuda_stem import fused_stem_cuda

    state = make_state_dict(seed, device)
    extractor = make_extractor(cell, state, device)
    h, w, b = mix["height"], mix["width"], mix["batch_images"]
    pool_u8 = make_images(mix["pool_images"], h, w, seed, device)
    pool = [im.astype(np.float32) / 255.0 for im in pool_u8]  # as load_image returns
    spans = Spans()
    spans.wrap(extractor, "_pad_batch", "extract.pad_and_upload")
    spans.wrap(extractor, "_run_packed", "extract.device_and_fetch")
    extractor.extract_batch(pool[:b])  # every shape of the window, once
    if device != "cpu":
        torch.cuda.synchronize()

    rng = np.random.default_rng(sub_seed(seed, 6))
    kept = {}  # step → (image indices, features)
    steps = 0
    done = 0
    t_start = time.perf_counter()
    setup_s = time.time() - ctx["t_process"]
    t_trace = t_start + seconds * mix["trace_from"] if ctx["trace"] else None
    trace = None
    while True:
        idx = rng.choice(len(pool), b, replace=False)
        if t_trace is not None and trace is None and time.perf_counter() >= t_trace:
            trace, k1_before = DeviceTrace(), fused_stem_cuda.shapes.copy()
            t_pause = time.perf_counter()
            trace.start()  # the profiler's start holds the loop for seconds
            paused_s = time.perf_counter() - t_pause
        t0 = time.perf_counter_ns()
        feats = extractor.extract_batch([pool[i] for i in idx])
        spans.add("extract.batch", t0, time.perf_counter_ns())
        if rng.random() < RECORD_SHARE or steps == 0:
            kept[steps] = (idx, feats)
        steps += 1
        done += len(feats)
        now = time.perf_counter()
        if trace is not None and trace.t1 is None and \
                now >= t_trace + seconds * mix["trace_share"]:
            trace.stop()
            k1_in_trace = fused_stem_cuda.shapes - k1_before
        if now - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    if trace is not None and trace.t1 is None:
        trace.stop()
        k1_in_trace = fused_stem_cuda.shapes - k1_before
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del extractor
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False  # the reference runs in full precision
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    numbers = verify(ctx, state, pool_u8, kept)
    numbers["check_s"] = time.perf_counter() - t_check
    layer_ctx = dict(images_done=done, window_s=window_s, height=h, width=w, spans=spans)
    if trace is not None:
        layer_ctx["window_s"] = window_s - paused_s
        layer_ctx["trace"] = trace.summary(spans)
        layer_ctx["k1_launches"] = dict(k1_in_trace)
    return dict(e2e={"images_per_s": done / window_s, "setup_s": setup_s}, numbers=numbers,
                attempted=done, failed=0, memory_peak_bytes=int(peak), layer_ctx=layer_ctx,
                trace=layer_ctx.get("trace"))


def reference_outputs(net: Net, image_u8: np.ndarray, knobs: dict, pad: int, device):
    """The reference's dense outputs and keypoints of one image, zero-padded
    as the program pads it."""
    h, w = image_u8.shape[:2]
    hp, wp = -(-h // pad) * pad, -(-w // pad) * pad
    x = torch.zeros((1, hp, wp, 3), dtype=torch.uint8, device=device)
    x[0, :h, :w] = torch.from_numpy(image_u8).to(device)
    with torch.no_grad():
        score, desc, stab = net.forward(normalise(x))
    kp = keypoints(score[0], desc[0], (w, h), knobs["max_keypoints"], knobs["conf_threshold"],
                   knobs["nms_radius"], knobs["border"])
    return (score[0], desc[0], stab[0]), tuple(t.cpu().numpy() for t in kp)


def sample_images(kept: dict, seed: int, n: int) -> list:
    """A seeded sample of (step, slot) among the kept calls."""
    slots = [(s, j) for s in sorted(kept) for j in range(len(kept[s][0]))]
    rng = np.random.default_rng(sub_seed(seed, 8))
    pick = rng.choice(len(slots), min(n, len(slots)), replace=False)
    return [slots[i] for i in sorted(pick)]


def verify(ctx, state, pool_u8, kept) -> dict:
    cell, device = ctx["cell"], ctx["device"]
    knobs = cell.config["extraction"]
    net = Net(state, "float32")
    worst = {"desc_gap": 0.0, "score_logit_gap": 0.0, "kp_miss_share": 0.0}
    checked = 0
    for step, slot in sample_images(kept, ctx["seed"], cell.mix["check_images"]):
        idx, feats = kept[step]
        f = feats[slot]
        dense, ref_kp = reference_outputs(net, pool_u8[idx[slot]], knobs, knobs["pad_multiple"],
                                          device)
        c = compare((f.keypoints, f.scores, f.descriptors), dense, ref_kp)
        for k in worst:
            worst[k] = max(worst[k], c[k])
        checked += 1
    return dict(worst, images_checked=checked)
