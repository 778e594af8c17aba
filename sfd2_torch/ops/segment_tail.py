"""The segmentor's tail fused on the device: slide average, resize back, argmax.

mmseg's slide inference (``EncoderDecoder.slide_inference``) upsamples each
crop's quarter-resolution logits to the crop (bilinear,
``align_corners=False``), averages them over the crops that cover a pixel of
the canvas, resizes the averaged logits of the image's region of the canvas
to the original size (bilinear) and takes the argmax over the classes. Done
step by step, the last two hold ``[C, H, W]`` float32 at the original size
(1.15 GB for 150 classes at 1600×1200) for an argmax that reduces it to one
byte a pixel.

Every step is linear in the logits and separable in rows and columns, and
the crops lie on a grid of row starts × column starts, so an output pixel
(Y, X) is a sum over the crops (i, j) that reach it of
``wy[Y, i, a] · wx[X, j, b] · L[(i, j), by[Y, i] + a, bx[X, j] + b, c]``
with a, b < 3: each axis's weights fold the two bilinear stages and the
crop count (``tail_plan``; at most three quarter-resolution taps per crop
and axis, since each stage takes two neighbouring taps and a crop's
logits are no larger than the crop). ``segment_tail`` applies them:

* on a CPU tensor, ``segment_tail_plain`` (gathers, a strip of output rows
  at a time);
* on a CUDA tensor, ``_segment_tail_kernel`` (Triton) or it raises. One
  program takes one output row of one image and ``BLOCK_X`` pixels of it,
  and walks the classes in chunks of ``BLOCK_C``. The block's pixels reach
  K consecutive quarter-resolution columns of each crop column j
  (``TailPlan.span``, from ``xq0``); for each such column it folds the rows
  (the at most three weighted quarter-resolution rows of each crop row:
  contiguous runs of classes, the logits being channels-last) and adds
  the column's weight for each pixel (``xwk``, zero for most) times that
  run into a [BLOCK_X, BLOCK_C] tile: outer products in registers, with
  no gather and no product through shared memory. It keeps a running
  maximum and its first index, and writes one uint8 label a pixel.
  Nothing at the original size but the labels is written. With
  ``labels=False`` the tile is stored instead: the averaged logits, used
  at the resized scale (``Segmentor.logits_batch``).

Replaces no TPU kernel: the JAX package's ``Segmentor`` averages and
resizes in XLA and takes the argmax on the host. What bounds it on the
card: its operations on the CUDA cores (two bilinear stages and the argmax
over 150 classes: ~3.4 GFLOP an image of 1600×1200 from two 512² crops,
against ~22 MB of logits in and labels out), so the design spends no
bytes on intermediates and reads each tap's classes as contiguous runs.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Sequence

import numpy as np
import torch

# The fastest of 8–64 pixels × 32–128 classes × 1–4 warps at the 1600×1200
# labels of two 512² crops on an H100: larger tiles unroll more columns (K)
# and spill.
BLOCK_X = 16  # output pixels of one program
BLOCK_C = 64  # classes a chunk
NUM_WARPS = 1
TAPS = 3  # quarter-resolution taps per crop and axis
PLAIN_ROWS = 16  # output rows a step of the plain version


def linear_taps(n_out: int, n_in: int):
    """torch's bilinear source taps (``align_corners=False``) along one axis:
    (i0, i1, weight of i1) for each of `n_out` outputs read from `n_in`."""
    src = np.maximum((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), src - i0


def resize_taps(n_out: int, n_in: int):
    """The taps of the resize from the region back to the original size."""
    return linear_taps(n_out, n_in)


class TailPlan(NamedTuple):
    """The folded weights of one geometry, on the device that runs it."""

    by: torch.Tensor  # [n_out_y, NI] int32: first quarter row of each crop row
    wy: torch.Tensor  # [n_out_y, NI, 3] float32
    bx: torch.Tensor  # [n_out_x, NJ] int32
    wx: torch.Tensor  # [n_out_x, NJ, 3] float32
    xq0: torch.Tensor  # [blocks, NJ] int32: each block's first quarter column per crop
    xwk: torch.Tensor  # [NJ, span, n_out_x] float32: each output's weight of column xq0 + k
    crop: tuple  # (crop_h, crop_w) each crop's logits are upsampled to
    region: tuple  # (rh, rw): the image's part of the canvas
    out: tuple  # (n_out_y, n_out_x)
    span: int  # the quarter columns a block reaches in a crop, a power of two


def axis_weights(n_out: int, n_region: int, starts: Sequence[int], crop: int, q: int):
    """(base [n_out, K] int64, weights [n_out, K, 3] float64) of one axis:
    the crop upsample (q → crop), the average over the K crop starts
    `starts`, and the resize of the region (n_region → n_out)."""
    starts = np.asarray(starts, np.int64)
    k = len(starts)
    dense = np.zeros((n_out, k, q))
    rows = np.arange(n_out)[:, None]
    cols = np.arange(k)[None, :]
    u0, u1, lu = linear_taps(crop, q)
    y0, y1, ly = resize_taps(n_out, n_region)
    for y, wy in ((y0, 1.0 - ly), (y1, ly)):
        cover = (starts[None, :] <= y[:, None]) & (y[:, None] < starts[None, :] + crop)
        share = wy[:, None] * cover / np.maximum(cover.sum(1), 1)[:, None]
        local = np.clip(y[:, None] - starts[None, :], 0, crop - 1)
        for qi, lw in ((u0[local], 1.0 - lu[local]), (u1[local], lu[local])):
            np.add.at(dense, (rows, cols, qi), share * lw)
    dense[np.abs(dense) < 1e-12] = 0.0
    nz = dense != 0
    base = np.where(nz.any(-1), nz.argmax(-1), 0)
    last = q - 1 - nz[..., ::-1].argmax(-1)
    if np.any(nz.any(-1) & (last - base >= TAPS)):
        raise ValueError("a crop's logits are larger than the crop: more than 3 taps an axis")
    idx = np.minimum(base[..., None] + np.arange(TAPS), q - 1)
    w = np.take_along_axis(dense, idx, -1)
    w[base[..., None] + np.arange(TAPS) > q - 1] = 0.0
    return base, w


def block_columns(base: np.ndarray, w: np.ndarray, block: int):
    """The x side of the kernel: (xq0 [blocks, NJ], xwk [NJ, span, n], span)
    for blocks of `block` outputs: each block's least base among outputs
    with any weight, and each output's weight of column xq0 + k."""
    n, nj = base.shape
    blocks = -(-n // block)
    q0 = np.zeros((blocks, nj), np.int64)
    for blk in range(blocks):
        sl = slice(blk * block, (blk + 1) * block)
        for j in range(nj):
            has = w[sl, j].sum(-1) > 0
            q0[blk, j] = base[sl, j][has].min() if has.any() else 0
    rel = (base - q0[np.arange(n) // block])[:, :, None] + np.arange(TAPS)
    nz = w != 0
    span = 1 << int(rel[nz].max(initial=0)).bit_length()
    wk = np.zeros((nj, span, n))
    p, j, t = np.nonzero(nz)
    np.add.at(wk, (j, rel[p, j, t], p), w[p, j, t])
    return q0, wk, span


def tail_plan(out: tuple, region: tuple, starts_y, starts_x, crop: tuple, q: tuple,
              device) -> TailPlan:
    """The plan of crops at `starts_y` × `starts_x` (row-major, as the
    logits are ordered per image), each upsampled from `q` to `crop`,
    averaged, the `region` resized to `out`."""
    by, wy = axis_weights(out[0], region[0], starts_y, crop[0], q[0])
    bx, wx = axis_weights(out[1], region[1], starts_x, crop[1], q[1])
    dev = torch.device(device)

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    q0, wk, span = block_columns(bx, wx, BLOCK_X)
    return TailPlan(t(by, torch.int32), t(wy, torch.float32), t(bx, torch.int32),
                    t(wx, torch.float32), t(q0, torch.int32), t(wk, torch.float32),
                    tuple(crop), tuple(region), tuple(out), span)


def segment_tail_plain(logits: torch.Tensor, plan: TailPlan, n_images: int,
                       labels: bool = True) -> torch.Tensor:
    """The contract in plain torch: logits [n_images · NI · NJ, QH, QW, C]
    float32 → labels [n_images, H, W] uint8 or, with ``labels=False``, the
    folded logits [n_images, H, W, C] float32; ``PLAIN_ROWS`` output rows
    at a time."""
    ni, nj = plan.by.shape[1], plan.bx.shape[1]
    _, qh, qw, c = logits.shape
    lg = logits.reshape(n_images, ni, nj, qh, qw, c)
    off = torch.arange(TAPS, device=logits.device)
    ry = (plan.by.long()[..., None] + off).clamp(max=qh - 1)  # [H, NI, 3]
    rx = (plan.bx.long()[..., None] + off).clamp(max=qw - 1)  # [W, NJ, 3]
    h, w = plan.out
    out = torch.empty((n_images, h, w) + (() if labels else (c,)),
                      dtype=torch.uint8 if labels else torch.float32, device=logits.device)
    for b in range(n_images):
        for y0 in range(0, h, PLAIN_ROWS):
            sl = slice(y0, min(y0 + PLAIN_ROWS, h))
            acc = torch.zeros((sl.stop - sl.start, w, c), device=logits.device)
            for i in range(ni):
                for j in range(nj):
                    t = (lg[b, i, j][ry[sl, i]] * plan.wy[sl, i, :, None, None]).sum(1)
                    acc += (t[:, rx[:, j]] * plan.wx[None, :, j, :, None]).sum(2)
            out[b, sl] = acc.argmax(-1).to(torch.uint8) if labels else acc
    return out


_kernel = None  # the Triton kernel, made on first use


def _triton_kernel():
    global _kernel
    if _kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _segment_tail_kernel(lg, by, wy, xq0, xwk, out, H, W, NI, QH, QW, C,
                                 NJ: tl.constexpr, K: tl.constexpr, BLOCK_X: tl.constexpr,
                                 BLOCK_C: tl.constexpr, LABELS: tl.constexpr):
            row = tl.program_id(0)  # image · H + output row
            blk = tl.program_id(1)
            b = row // H
            y = row % H
            xs = blk * BLOCK_X + tl.arange(0, BLOCK_X)
            xm = xs < W
            best = tl.full([BLOCK_X], float("-inf"), tl.float32)
            best_i = tl.zeros([BLOCK_X], tl.int32)
            for c0 in range(0, C, BLOCK_C):
                cs = c0 + tl.arange(0, BLOCK_C)
                cm = cs < C
                acc = tl.zeros([BLOCK_X, BLOCK_C], tl.float32)
                for j in tl.static_range(NJ):
                    q0 = tl.load(xq0 + blk * NJ + j)
                    for k in tl.static_range(K):
                        col = q0 + k
                        wk = tl.load(xwk + (j * K + k) * W + xs, mask=xm, other=0.0)
                        line = tl.zeros([BLOCK_C], tl.float32)
                        for i in range(NI):
                            qy0 = tl.load(by + y * NI + i)
                            crop = (b * NI + i) * NJ + j
                            for a in tl.static_range(3):
                                way = tl.load(wy + (y * NI + i) * 3 + a)
                                qy = tl.minimum(qy0 + a, QH - 1)
                                off = ((crop * QH + qy).to(tl.int64) * QW + col) * C
                                m = cm & (col < QW) & (way != 0.0)
                                line += way * tl.load(lg + off + cs, mask=m, other=0.0)
                        acc += wk[:, None] * line[None, :]
                if LABELS:
                    acc = tl.where(cm[None, :], acc, float("-inf"))
                    m = tl.max(acc, axis=1)
                    better = m > best
                    best_i = tl.where(better, tl.argmax(acc, axis=1) + c0, best_i)
                    best = tl.where(better, m, best)
                else:
                    optr = out + (row.to(tl.int64) * W + xs)[:, None] * C + cs[None, :]
                    tl.store(optr, acc, mask=xm[:, None] & cm[None, :])
            if LABELS:
                tl.store(out + row.to(tl.int64) * W + xs, best_i.to(tl.uint8), mask=xm)

        _kernel = (triton, _segment_tail_kernel)
    return _kernel


def segment_tail(logits: torch.Tensor, plan: TailPlan, n_images: int,
                 labels: bool = True) -> torch.Tensor:
    """``segment_tail_plain``'s contract: on a CPU tensor the plain version,
    on a CUDA tensor the kernel (or it raises)."""
    if logits.device.type == "cpu":
        return segment_tail_plain(logits, plan, n_images, labels)
    if not logits.is_cuda:
        raise ValueError(f"segment_tail: unsupported device {logits.device}")
    if logits.dim() != 4 or logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError(f"segment_tail: need contiguous float32 [N, QH, QW, C], got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    ni, nj = plan.by.shape[1], plan.bx.shape[1]
    n, qh, qw, c = logits.shape
    if n != n_images * ni * nj or (labels and c > 256):
        raise ValueError(f"segment_tail: {n} crops of logits for {n_images} images of "
                         f"{ni}×{nj} crops, {c} classes")
    if any(t.device != logits.device for t in plan[:6]):
        raise ValueError("segment_tail: the plan lies on another device than the logits")
    h, w = plan.out
    out = torch.empty((n_images, h, w) + (() if labels else (c,)),
                      dtype=torch.uint8 if labels else torch.float32, device=logits.device)
    triton, kernel = _triton_kernel()
    grid = (n_images * h, triton.cdiv(w, BLOCK_X))
    with torch.cuda.device(logits.device):
        kernel[grid](logits, plan.by, plan.wy, plan.xq0, plan.xwk, out, h, w, ni, qh, qw, c,
                     NJ=nj, K=plan.span, BLOCK_X=BLOCK_X, BLOCK_C=BLOCK_C, LABELS=labels,
                     num_warps=NUM_WARPS)
    segment_tail.launches += 1
    segment_tail.shapes[(n_images, ni * nj, *plan.crop, qh, qw, *plan.region, h, w, c,
                         labels)] += 1
    return out


segment_tail.launches = 0
# (images, crops an image, crop h, crop w, QH, QW, region h, region w, out h,
# out w, classes, labels) of each launch
segment_tail.shapes = collections.Counter()
