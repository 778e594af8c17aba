"""Alternative training losses selectable by config.

Port of ``sfd2_tpu/training/extra_losses.py``:
* ``nets/repeatability_loss.py`` — CosimLoss (patch cosine similarity of
  the flow-warped score maps, N=16) and PeakyLoss (1 − (local max − local
  mean));
* ``nets/reliability_loss.py:514`` — TripletLossV2, the D2Net-style margin
  loss on the 1/4-res descriptor grid with a score-weighted mean, and its
  label-aware hardest negative;
* ``nets/reliability_loss.py:132`` — TripletLoss v1 (symmetric hardest
  negative over grids of both images, manhattan-gated,
  reliability-weighted) and ``:369`` — v3 (sqrt distances, candidates gated
  by conf ≥ 0.51 and seg validity, the hardest negative restricted to the
  query's semantic label, hinge averaged over active rows).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sfd2_torch.ops.grid_sample import grid_sample_bilinear
from sfd2_torch.training.sampler import downscale_positions
from sfd2_torch.utils.device import to_device


def _warp_by_flow(fmap: torch.Tensor, aflow: torch.Tensor) -> torch.Tensor:
    """Sample `fmap` [B, H, W, C] of image 2 at img1's flow targets;
    invalid (NaN) flow samples to 0 (FullSampler._warp semantics)."""
    h, w = fmap.shape[1], fmap.shape[2]
    gx = aflow[..., 0] * (2.0 / (w - 1)) - 1.0
    gy = aflow[..., 1] * (2.0 / (h - 1)) - 1.0
    bad = ~torch.isfinite(gx) | ~torch.isfinite(gy)
    grid = torch.stack([torch.where(bad, 9e9, gx), torch.where(bad, 9e9, gy)], -1)
    return torch.stack([grid_sample_bilinear(fmap[i], grid[i], align_corners=True)
                        for i in range(fmap.shape[0])])


def cosim_loss(score1: torch.Tensor, score2: torch.Tensor, aflow: torch.Tensor, n: int = 16):
    """1 − mean patchwise cosine similarity between img1's score map and
    img2's map warped into img1 (CosimLoss, N=16)."""
    b, h, w = score1.shape
    warped = _warp_by_flow(score2[..., None], aflow)[..., 0]
    ph, pw = h // n, w // n

    def patches(x):
        x = x[:, : ph * n, : pw * n]
        x = x.reshape(b, ph, n, pw, n).permute(0, 1, 3, 2, 4).reshape(b, ph * pw, n * n)
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-8)

    return 1.0 - (patches(score1) * patches(warped)).sum(-1).mean()


def peaky_loss(score: torch.Tensor, n: int = 16):
    """1 − mean(local max − local mean) over N×N windows (PeakyLoss)."""
    x = score[:, None]
    local_max = F.max_pool2d(x, n, n)[:, 0]
    local_mean = F.avg_pool2d(x, n, n)[:, 0]
    return 1.0 - (local_max - local_mean).mean()


def triplet_loss_d2net(desc1, desc2, score1, score2, aflow, margin: float = 1.0,
                       scaling_step: int = 2, safe_radius: int = 4, stride: int = 2,
                       labels1=None, labels2=None):
    """D2Net-style triplet on the descriptor grid (TripletLossV2): for each
    grid cell of img1 with valid flow, positive = img2's cell at the flow
    target, hardest negative = the best-matching cell outside
    `safe_radius` of the target (optionally also of another label); loss =
    score-weighted mean of relu(margin + d(pos) − d(neg)). desc [B,h,w,D],
    score [B,H,W] full res, aflow [B,H,W,2]."""
    b, h, w, d = desc1.shape
    dev = desc1.device
    gy, gx = torch.meshgrid(torch.arange(0, h, stride, device=dev),
                            torch.arange(0, w, stride, device=dev), indexing="ij")
    gy, gx = gy.reshape(-1), gx.reshape(-1)
    scale = 2**scaling_step
    hf, wf = score1.shape[1], score1.shape[2]
    yu = (gy * scale + scale // 2).clamp(0, hf - 1)
    xu = (gx * scale + scale // 2).clamp(0, wf - 1)
    yy = torch.arange(h * w, device=dev) // w
    xx = torch.arange(h * w, device=dev) % w

    def one_image(d1, d2, s1, s2, fl, l1, l2):
        anchors = d1[gy, gx]  # [Nq, D]
        w1 = s1[yu, xu]
        target = fl[yu, xu]
        ok = torch.isfinite(target).all(-1)
        tgt = torch.floor(downscale_positions(torch.where(ok[:, None], target, 0.0),
                                              scaling_step)).long()
        tx, ty = tgt[:, 0].clamp(0, w - 1), tgt[:, 1].clamp(0, h - 1)
        ok = ok & (tgt[:, 0] >= 0) & (tgt[:, 1] >= 0) & (tgt[:, 0] < w) & (tgt[:, 1] < h)
        pos = d2[ty, tx]
        w2 = s2[(ty * scale + scale // 2).clamp(0, hf - 1),
                (tx * scale + scale // 2).clamp(0, wf - 1)]
        sim = anchors @ d2.reshape(h * w, d).T  # [Nq, h*w]
        near = (((yy[None, :] - ty[:, None]).abs() <= safe_radius)
                & ((xx[None, :] - tx[:, None]).abs() <= safe_radius))
        if l1 is not None and l2 is not None:
            near = near | (l1[gy, gx][:, None] == l2.reshape(-1)[None, :])
        neg_sim = torch.where(near, -torch.inf, sim).max(1).values
        d_pos = torch.sqrt(torch.clamp(2 - 2 * (anchors * pos).sum(-1), min=1e-12))
        d_neg = torch.sqrt(torch.clamp(2 - 2 * neg_sim, min=1e-12))
        per = F.relu(margin + d_pos - d_neg)
        wgt = w1 * w2 * ok.to(d1.dtype)
        return (per * wgt).sum() / torch.clamp(wgt.sum(), min=1e-8)

    losses = [one_image(desc1[i], desc2[i], score1[i], score2[i], aflow[i],
                        None if labels1 is None else labels1[i],
                        None if labels2 is None else labels2[i]) for i in range(b)]
    return torch.stack(losses).mean()


def _grid_yx(border: int, step: int, h: int, w: int, device):
    gy, gx = np.meshgrid(np.arange(border, h - border, step),
                         np.arange(border, w - border, step), indexing="ij")
    return to_device(gy.reshape(-1), device), to_device(gx.reshape(-1), device)


def _flow_targets(fl, gy, gx, h, w):
    """Rounded flow targets of the grid cells: (ok, tx, ty), clamped."""
    target = fl[gy, gx]
    ok = torch.isfinite(target).all(-1)
    t = torch.floor(torch.where(ok[:, None], target, 0.0) + 0.5).long()
    tx, ty = t[:, 0], t[:, 1]
    ok = ok & (tx >= 0) & (ty >= 0) & (tx < w) & (ty < h)
    return ok, tx.clamp(0, w - 1), ty.clamp(0, h - 1)


def triplet_loss_v1(desc1, desc2, conf1, conf2, aflow, step: int = 8, margin: float = 1.0,
                    border: int = 16, near_l1: int = 3):
    """TripletLoss v1 (``nets/reliability_loss.py:132-249``): queries on a
    strided grid of img1, positive = img2 at the flow target, hardest
    negative = min squared-L2 over the same grid in either image, without
    candidates within `near_l1` manhattan distance of the correspondence
    (+10, the reference's sentinel); mean over valid rows of
    relu(margin + d_pos − min(neg1, neg2)) · (conf1+conf2)/2."""
    b, h, w, d = desc1.shape
    gy, gx = _grid_yx(border, step, h, w, desc1.device)

    def one(d1, d2, c1, c2, fl):
        ok, tx, ty = _flow_targets(fl, gy, gx, h, w)
        f1, f2 = d1[gy, gx], d2[ty, tx]
        pos_dist = 2.0 - 2.0 * (f1 * f2).sum(-1)
        nd1 = 2.0 - 2.0 * (f1 @ d2[gy, gx].T)
        l1_2 = (tx[:, None] - gx[None, :]).abs() + (ty[:, None] - gy[None, :]).abs()
        nd1 = (nd1 + (l1_2 < near_l1) * 10.0).min(1).values
        nd2 = 2.0 - 2.0 * (f2 @ d1[gy, gx].T)
        l1_1 = (gx[:, None] - gx[None, :]).abs() + (gy[:, None] - gy[None, :]).abs()
        nd2 = (nd2 + (l1_1 < near_l1) * 10.0).min(1).values
        diff = F.relu(margin + pos_dist - torch.minimum(nd1, nd2))
        conf12 = (c1[gy, gx] + c2[ty, tx]) / 2.0
        wgt = ok.to(d1.dtype)
        return (diff * conf12 * wgt).sum() / torch.clamp(wgt.sum(), min=1.0)

    return torch.stack([one(desc1[i], desc2[i], conf1[i], conf2[i], aflow[i])
                        for i in range(b)]).mean()


def triplet_loss_v3(desc1, desc2, conf1, conf2, aflow, seg1, seg2, seg_mask1, seg_mask2,
                    margin: float = 1.0, border: int = 16, conf_th: float = 0.51,
                    near_r: float = 3.0):
    """TripletLoss v3 (``nets/reliability_loss.py:369-513``), seg-aware:
    sqrt descriptor distances; negative candidates gated by reliability ≥
    conf_th and seg validity; candidates within euclidean `near_r` of the
    correspondence or of another semantic label excluded (+10); the hinge
    summed over active (diff > 0) rows, over their count. A static grid
    with masks stands for the reference's random positions, as in the JAX
    package."""
    b, h, w, d = desc1.shape
    gy, gx = _grid_yx(border, 2, h, w, desc1.device)

    def one(d1, d2, c1, c2, fl, s1, s2, m1, m2):
        c1_ok = (c1[gy, gx] >= conf_th) & m1[gy, gx]
        c2_ok = (c2[gy, gx] >= conf_th) & m2[gy, gx]
        ok, tx, ty = _flow_targets(fl, gy, gx, h, w)
        ok = ok & c1_ok
        f1, f2 = d1[gy, gx], d2[ty, tx]
        pos_dist = torch.sqrt(torch.clamp(2.0 - 2.0 * (f1 * f2).sum(-1), min=0.0) + 1e-4)
        seg1_q, seg2_t = s1[gy, gx], s2[ty, tx]

        nd1 = torch.sqrt(torch.clamp(2.0 - 2.0 * (f1 @ d2[gy, gx].T), min=0.0) + 1e-4)
        d2_2 = torch.sqrt((tx[:, None] - gx[None, :]).float() ** 2
                          + (ty[:, None] - gy[None, :]).float() ** 2)
        pen1 = ((d2_2 <= near_r) * 10.0 + (seg2_t[:, None] != s2[gy, gx][None, :]) * 10.0
                + (~c2_ok)[None, :] * 10.0)
        nd1 = (nd1 + pen1.to(nd1.dtype)).min(1).values

        nd2 = torch.sqrt(torch.clamp(2.0 - 2.0 * (f2 @ f1.T), min=0.0) + 1e-4)
        d2_1 = torch.sqrt((gx[:, None] - gx[None, :]).float() ** 2
                          + (gy[:, None] - gy[None, :]).float() ** 2)
        pen2 = ((d2_1 <= near_r) * 10.0 + (seg1_q[:, None] != seg1_q[None, :]) * 10.0
                + (~c1_ok)[None, :] * 10.0)
        nd2 = (nd2 + pen2.to(nd2.dtype)).min(1).values

        diff = margin + pos_dist - torch.minimum(nd1, nd2)
        conf12 = (c1[gy, gx] + c2[ty, tx]) / 2.0
        active = ok & (diff > 0)
        return (diff * conf12 * active).sum() / torch.clamp(active.to(d1.dtype).sum(), min=1.0)

    return torch.stack([one(desc1[i], desc2[i], conf1[i], conf2[i], aflow[i], seg1[i], seg2[i],
                            seg_mask1[i], seg_mask2[i]) for i in range(b)]).mean()
