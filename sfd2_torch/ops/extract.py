"""Batched keypoint extraction: NMS → threshold → border → top-K → descs.

Port of ``sfd2_tpu/ops/extract.py`` (``nets/extractor.py:97`` semantics:
NMS radius 4, conf_th 0.001, border 4, top-K by score, bilinear
descriptor lookup on the 1/4-res map with re-L2-normalisation), fixed
shape: padded ``[B, K]`` arrays with a validity mask. With a label map the
top-K is labelled-first (``nets/extractor.py:240-326``) and each keypoint
carries its semantic id.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sfd2_torch.ops.grid_sample import sample_at_points
from sfd2_torch.ops.nms import simple_nms


class Keypoints(NamedTuple):
    """Padded keypoint set. Invalid rows have valid=False, score=0."""

    xy: torch.Tensor  # [B, K, 2] float32, (x, y) pixel coords at full res
    scores: torch.Tensor  # [B, K]
    descriptors: torch.Tensor  # [B, K, C] L2-normalised
    valid: torch.Tensor  # [B, K] bool
    labels: Optional[torch.Tensor] = None  # [B, K] int32 semantic ids (0 = none)


def sample_descriptors(desc_map: torch.Tensor, xy: torch.Tensor, full_hw) -> torch.Tensor:
    """Sample [h, w, C] `desc_map` at full-resolution keypoints `xy` [K, 2]
    and L2-normalise."""
    h_c, w_c = desc_map.shape[0], desc_map.shape[1]
    full_h, full_w = full_hw
    cx = xy[..., 0] * (w_c / full_w) - 0.5
    cy = xy[..., 1] * (h_c / full_h) - 0.5
    d = sample_at_points(desc_map, torch.stack([cx, cy], dim=-1), padding_mode="zeros")
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)


def _top_k_nms_cells(masked: torch.Tensor, k: int, h: int, w: int):
    """Exact two-stage top-k for NMS'd maps (``sfd2_tpu/ops/extract.py:58``):
    a radius ≥ 3 NMS survivor is the strict maximum of its window, so a
    4×4 cell holds at most one finite candidate; top-k runs on per-cell
    maxima and the in-cell offset is the cell's first argmax. Tie caveat
    as in the JAX package: an exact tie between two survivors of one cell
    keeps one of them, and ``torch.topk`` promises no order among equal
    values (on CUDA), so equal-score keypoints may come in another order."""
    b = masked.shape[0]
    ch, cw = h // 4, w // 4
    mr = masked.reshape(b, ch, 4, cw, 4).permute(0, 1, 3, 2, 4).reshape(b, ch * cw, 16)
    vals, cid = torch.topk(torch.amax(mr, dim=-1), k, dim=-1)
    rows = torch.gather(mr, 1, cid[:, :, None].expand(b, k, 16))
    off = torch.argmax(rows, dim=-1)
    y = (cid // cw) * 4 + off // 4
    x = (cid % cw) * 4 + off % 4
    return vals, y * w + x


def extract_keypoints(heatmap: torch.Tensor, desc_map: torch.Tensor,
                      stability: Optional[torch.Tensor] = None,
                      sizes: Optional[torch.Tensor] = None,
                      label_map: Optional[torch.Tensor] = None, *,
                      max_keypoints: int = 4096, conf_threshold: float = 0.001,
                      nms_radius: int = 4, border: int = 4) -> Keypoints:
    """Full extraction over a batch.

    heatmap [B, H, W]; desc_map [B, h, w, C]; stability [B, H, W]
    multiplier; sizes [B, 2] true (w, h) of zero-padded images (the border
    filter applies at the true edge, padding never takes top-K slots);
    label_map [B, H, W] int32 semantic ids (0 = unlabelled). With a label
    map the top-K is labelled-first: every labelled candidate ranks above
    every unlabelled one, each block sorted by score (one top-K on the
    composite key score + (max score + 1) for labelled pixels, the max
    taken over the whole batch in float32), and ``labels`` holds each
    keypoint's id. Rows are sorted by descending score (by descending key
    with a label map)."""
    b, h, w = heatmap.shape
    k = max_keypoints
    dev = heatmap.device
    if stability is not None:
        heatmap = heatmap * stability
    scores = simple_nms(heatmap, nms_radius)

    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    if sizes is None:
        border_ok = ((xs >= border) & (xs < w - border) & (ys >= border)
                     & (ys < h - border))[None]
    else:
        w_i = sizes[:, 0].to(dev)[:, None, None]
        h_i = sizes[:, 1].to(dev)[:, None, None]
        border_ok = ((xs[None] >= border) & (xs[None] < w_i - border)
                     & (ys[None] >= border) & (ys[None] < h_i - border))
    keep = (scores > conf_threshold) & border_ok
    masked = torch.where(keep, scores, float("-inf")).reshape(b, h * w)

    if label_map is not None:
        labeled = (label_map > 0).reshape(b, h * w)
        boost = torch.amax(torch.where(torch.isfinite(masked), masked, 0.0)) + 1.0
        _, top_idx = torch.topk(torch.where(labeled, masked + boost, masked), k, dim=-1)
        top_scores = torch.gather(masked, 1, top_idx)
    elif h % 4 == 0 and w % 4 == 0 and nms_radius >= 3 and k <= (h // 4) * (w // 4):
        top_scores, top_idx = _top_k_nms_cells(masked, k, h, w)
    else:
        top_scores, top_idx = torch.topk(masked, k, dim=-1)
    valid = torch.isfinite(top_scores)
    top_scores = torch.where(valid, top_scores, 0.0)
    xy = torch.stack([(top_idx % w).float(), (top_idx // w).float()], dim=-1)

    descs = torch.stack([sample_descriptors(desc_map[i], xy[i], (h, w)) for i in range(b)])
    descs = torch.where(valid[..., None], descs, 0.0)
    labels = None
    if label_map is not None:
        labels = torch.gather(label_map.reshape(b, h * w).to(torch.int32), 1, top_idx)
        labels = torch.where(valid, labels, 0)
    return Keypoints(xy=xy, scores=top_scores, descriptors=descs, valid=valid, labels=labels)
