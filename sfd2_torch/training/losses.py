"""SFD2 multi-task training losses.

Port of ``sfd2_tpu/training/losses.py`` (``nets/losses.py`` SegLoss +
``nets/reliability_loss.py`` ReliabilityLoss / PixelAPLoss). Terms, with
the shipped configuration's weights (``configs/config_train_sfd2.json``):

* det_loss — CE between the student's 65-channel normalised ``semi`` and
  SuperPoint's ('ce'); 'l1' / 'bce' on the full-res maps with the
  ≥score_th weight map; 'sce' with the semantic-modulated target.
* desc_loss — ReliabilityLoss, 1 − AP·rel − (1−rel)·base over the sampler's
  rows ('wapv2'), or the triplet family ('tripletv1|v2|v3').
* seg_det_loss — the stability head against the seg-confidence classes
  (3-class CE on the softmaxed map, as the reference) or BCE for V1.
* seg_feat_loss — L1 feature consistency against the ConvNeXt teacher.
* seg_desc_loss — the inter/intra-class two-margin descriptor loss over
  the top-scoring pixels ('2mf' with self-pairs, '2m', 'wap').

The JAX package's deliberate deviations from the reference carry over
(``README.md``, deviations): 'sce' uses the modulated target the reference
computes and then drops; seg_desc takes the top-k pixels per image half
in place of a global threshold; positions downscale by log2(H/h) where
the reference divides by H/h. Ties in that top-k go to the lower pixel
index, as ``jax.lax.top_k`` (a stable descending sort).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sfd2_torch.models.sfd2 import _pixel_shuffle_score
from sfd2_torch.training.ap_loss import compute_ap
from sfd2_torch.training.extra_losses import (triplet_loss_d2net, triplet_loss_v1,
                                              triplet_loss_v3)
from sfd2_torch.training.sampler import NghSampler2DS, downscale_positions, upscale_positions
from sfd2_torch.training.semantics import confidence_to_class


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def reliability_loss(gen, desc1, desc2, rel1, rel2, aflow, sampler: NghSampler2DS,
                     base: float = 0.5, nq: int = 20, positions=None) -> torch.Tensor:
    """1 − AP·rel − (1−rel)·base, averaged over valid query pixels."""
    s = sampler(gen, desc1, desc2, rel1, rel2, aflow, positions=positions)
    ap = compute_ap(s.scores, s.gt, weights=s.col_weights, nq=nq)
    loss = 1.0 - ap * s.qconf - (1.0 - s.qconf) * base
    return _masked_mean(loss, s.mask)


@dataclasses.dataclass(frozen=True)
class SegLossConfig:
    det_loss: str = "ce"  # ce | l1 | bce | sce
    # Descriptor-loss family (reference --loss, train.py:80,195): wapv2 =
    # ReliabilityLoss over the sampler (shipped), tripletv1/v2/v3 =
    # nets/reliability_loss.py:132/514/369.
    desc_loss: str = "wapv2"
    seg_desc_loss_fn: str = "2mf"  # 2mf | 2m | wap
    use_pred_score_desc: bool = True
    seg_det: bool = True
    seg_cls: bool = True
    seg_desc: bool = True
    seg_feat: bool = True
    margin: float = 1.0
    base: float = 0.5
    nq: int = 20
    topk_per_half: int = 1000  # per image: pixels that enter seg_desc
    w_det: float = 1.0
    w_desc: float = 1.0
    w_seg_det: float = 1.0
    w_seg_desc: float = 1.0
    w_seg_feat: float = 0.5

    def __post_init__(self):
        if self.det_loss == "cel":
            # A config-time error, not a silent fallback: the reference's
            # 'cel' (nets/losses.py:326-330) consumes detector LOGITS, which
            # the shipped ResSegNet forward never exposes (README.md,
            # deviations).
            raise ValueError(
                "det_loss='cel' is intentionally unsupported: it needs "
                "detector logits the shipped SFD2 model never outputs "
                "(see README.md deviations). Use 'ce' (default), 'l1', "
                "'bce' or 'sce'.")
        if self.det_loss not in ("ce", "l1", "bce", "sce"):
            raise ValueError(f"unknown det_loss {self.det_loss!r}; choose from ce|l1|bce|sce")


class SegLossInputs(NamedTuple):
    """Everything the loss consumes; the first half of the batch is image 1,
    the second image 2 (``nets/sfd2.py:405``). NHWC layouts."""

    semi: torch.Tensor  # [2B, hc, wc, 65] student normalised semi
    gt_semi: torch.Tensor  # [2B, hc, wc, 65] SuperPoint normalised semi
    score: torch.Tensor  # [2B, H, W] student score (stability-folded)
    gt_score: torch.Tensor  # [2B, H, W] SuperPoint score
    desc: torch.Tensor  # [2B, h, w, D]
    aflow: torch.Tensor  # [B, H, W, 2] img1→img2 flow (NaN = invalid)
    weight: torch.Tensor  # [2B, H, W] det-weight map
    seg_confidence: Optional[torch.Tensor] = None  # [2B, H, W] ∈ {0.1,0.5,1.0}
    seg_mask: Optional[torch.Tensor] = None  # [2B, H, W] bool
    seg: Optional[torch.Tensor] = None  # [2B, H, W] ADE class map (int)
    stability: Optional[torch.Tensor] = None  # [2B, H, W, 3] softmaxed logits
    pred_feats: Tuple[torch.Tensor, ...] = ()
    gt_feats: Tuple[torch.Tensor, ...] = ()


def _ce(target, semi):
    return -(target * torch.log(torch.clamp(semi, min=1e-12))).sum(-1).mean()


def _det_loss(cfg: SegLossConfig, inp: SegLossInputs) -> torch.Tensor:
    if cfg.det_loss == "ce":
        return _ce(inp.gt_semi, inp.semi)
    if cfg.det_loss == "l1":
        return ((inp.score - inp.gt_score).abs() * inp.weight).mean()
    if cfg.det_loss == "bce":
        p = torch.clamp(inp.score, 1e-6, 1 - 1e-6)
        bce = -(inp.gt_score * torch.log(p) + (1 - inp.gt_score) * torch.log(1 - p))
        return (bce * inp.weight).mean()
    # 'sce' (nets/losses.py:363-389): damp SuperPoint's target by the pixel's
    # semantic confidence, m = r − r·a/(1 − r·a), repack to 64 cells +
    # dustbin, renormalise — and use it (the reference passes the
    # unmodulated target to its CE, :385).
    b, hc, wc, _ = inp.gt_semi.shape
    r = torch.where(inp.seg_mask, inp.seg_confidence, 1.0)
    a = _pixel_shuffle_score(inp.gt_semi.permute(0, 3, 1, 2))  # [2B, H, W]
    m = torch.clamp(r - r * a / torch.clamp(1.0 - r * a, min=1e-6), min=0.0)
    m = m.reshape(b, hc, 8, wc, 8).permute(0, 1, 3, 2, 4).reshape(b, hc, wc, 64)
    sgt = torch.cat([m, inp.gt_semi[..., 64:]], -1)
    sgt = sgt / torch.clamp(sgt.sum(-1, keepdim=True), min=1e-12)
    return _ce(sgt, inp.semi)


def _seg_det_loss(cfg: SegLossConfig, inp: SegLossInputs) -> torch.Tensor:
    if cfg.seg_cls:
        # CrossEntropy on the *softmaxed* stability map, as the reference.
        logp = torch.log(torch.clamp(torch.softmax(inp.stability, -1), min=1e-12))
        cls = confidence_to_class(inp.seg_confidence)
        return -torch.gather(logp, -1, cls[..., None])[..., 0].mean()
    # V1: BCE between the sigmoid stability and the confidence map.
    p = torch.clamp(inp.stability[..., 0], 1e-6, 1 - 1e-6)
    c = inp.seg_confidence
    return _masked_mean(-(c * torch.log(p) + (1 - c) * torch.log(1 - p)), inp.seg_mask)


def _seg_feat_loss(inp: SegLossInputs) -> torch.Tensor:
    total = 0.0
    for pfeat, gfeat in zip(inp.pred_feats, inp.gt_feats):
        if pfeat.shape[1:3] != gfeat.shape[1:3]:
            # F.interpolate's default, nearest.
            rh, rw = pfeat.shape[1] // gfeat.shape[1], pfeat.shape[2] // gfeat.shape[2]
            if rh >= 1 and rw >= 1:
                pfeat = pfeat[:, ::rh, ::rw]
            else:
                pfeat = pfeat.repeat_interleave(gfeat.shape[1] // pfeat.shape[1], 1)
                pfeat = pfeat.repeat_interleave(gfeat.shape[2] // pfeat.shape[2], 2)
        total = total + (pfeat - gfeat).abs().mean()
    return total / max(len(inp.pred_feats), 1)


def _select_topk_pixels(scores: torch.Tensor, k: int):
    """The k top-scoring pixels of each image: (b, y, x, value), flat.
    A stable descending sort gives ties to the lower index, as lax.top_k."""
    half, h, w = scores.shape
    vals, idx = torch.sort(scores.reshape(half, h * w), dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    bs = torch.arange(half, device=scores.device)[:, None].expand(-1, k)
    return bs.reshape(-1), (idx // w).reshape(-1), (idx % w).reshape(-1), vals.reshape(-1)


def _seg_desc_loss(cfg: SegLossConfig, inp: SegLossInputs) -> torch.Tensor:
    two_b, hf, _ = inp.gt_score.shape
    b = two_b // 2
    h, w = inp.desc.shape[1], inp.desc.shape[2]
    scale_steps = max((hf // h).bit_length() - 1, 0)  # log2 of full/desc ratio

    def half(sl):
        bs, ys, xs, vals = _select_topk_pixels(inp.gt_score[sl], cfg.topk_per_half)
        w_pix = torch.clamp(torch.clamp(vals, 5e-4, 1.0) * 2.0 + 0.5, 5e-4, 1.0)
        w_pix = w_pix * inp.seg_mask[sl][bs, ys, xs].to(w_pix.dtype)
        yd = torch.floor(downscale_positions(ys.float(), scale_steps)).clamp(0, h - 1).long()
        xd = torch.floor(downscale_positions(xs.float(), scale_steps)).clamp(0, w - 1).long()
        return inp.desc[sl][bs, yd, xd], inp.seg[sl][bs, ys, xs], w_pix

    d1, s1, w1 = half(slice(0, b))
    d2, s2, w2 = half(slice(b, two_b))

    def pairs(da, db, wa, wb, sa, sb):
        dist = 2.0 - 2.0 * (da @ db.T)
        same = sa[:, None] == sb[None, :]
        wpair = wa[:, None] * wb[None, :]
        valid = wpair > 0
        return dist, wpair, same & valid, (~same) & valid

    def two_margin(*args):
        dist, wpair, pos, neg = pairs(*args)
        return (_masked_mean(F.relu(dist - cfg.margin) * wpair, pos)
                + _masked_mean(F.relu(cfg.margin - dist) * wpair, neg))

    if cfg.seg_desc_loss_fn == "wap":
        # Single margin (sem_desc_loss_wap_ds:80): margin + mean(pos·w) −
        # mean(neg·w) on raw distances.
        dist, wpair, pos, neg = pairs(d1, d2, w1, w2, s1, s2)
        return cfg.margin + _masked_mean(dist * wpair, pos) - _masked_mean(dist * wpair, neg)
    d12 = two_margin(d1, d2, w1, w2, s1, s2)
    if cfg.seg_desc_loss_fn == "2mf":
        return (d12 + two_margin(d1, d1, w1, w1, s1, s1)
                + two_margin(d2, d2, w2, w2, s2, s2)) / 3.0
    return d12  # '2m'


def _unsup_desc_loss(gen, cfg: SegLossConfig, inp: SegLossInputs, sampler, rel, b: int,
                     positions=None) -> torch.Tensor:
    """The descriptor-loss family (reference ``--loss``)."""
    desc1, desc2 = inp.desc[:b], inp.desc[b:]
    rel1, rel2 = rel[:b], rel[b:]
    if cfg.desc_loss == "wapv2":
        return reliability_loss(gen, desc1, desc2, rel1, rel2, inp.aflow, sampler,
                                base=cfg.base, nq=cfg.nq, positions=positions)
    step = getattr(sampler, "scaling_step", 2)
    if cfg.desc_loss == "tripletv2":
        return triplet_loss_d2net(desc1, desc2, rel1, rel2, inp.aflow, margin=cfg.margin,
                                  scaling_step=step)
    # v1/v3 run on the descriptor grid: sample the full-res maps there.
    h, w = desc1.shape[1], desc1.shape[2]
    hf, wf = rel.shape[1], rel.shape[2]
    dev = rel.device
    yc = upscale_positions(torch.arange(h, dtype=torch.float32, device=dev), step).long()
    xc = upscale_positions(torch.arange(w, dtype=torch.float32, device=dev), step).long()
    yc, xc = yc.clamp(0, hf - 1), xc.clamp(0, wf - 1)

    def ds_map(m):
        return m[:, yc][:, :, xc]

    rel1_c, rel2_c = ds_map(rel1), ds_map(rel2)
    aflow_c = downscale_positions(ds_map(inp.aflow), step)
    border = max(2, min(16, h // 4))
    if cfg.desc_loss == "tripletv1":
        return triplet_loss_v1(desc1, desc2, rel1_c, rel2_c, aflow_c,
                               step=max(1, 8 // 2**step), margin=cfg.margin, border=border)
    if cfg.desc_loss == "tripletv3":
        if inp.seg is None:
            raise ValueError("tripletv3 needs semantic labels (inp.seg)")
        seg_c = ds_map(inp.seg)
        segm = (ds_map(inp.seg_mask) if inp.seg_mask is not None
                else torch.ones_like(seg_c, dtype=torch.bool))
        return triplet_loss_v3(desc1, desc2, rel1_c, rel2_c, aflow_c, seg_c[:b], seg_c[b:],
                               segm[:b], segm[b:], margin=cfg.margin, border=border)
    raise ValueError(f"unknown desc_loss {cfg.desc_loss!r}")


def seg_loss(gen, inp: SegLossInputs, sampler: NghSampler2DS,
             cfg: SegLossConfig = SegLossConfig(), positions=None) -> Dict[str, torch.Tensor]:
    """The whole multi-task loss: {'loss': total, one entry per term}.
    `gen` draws the sampler's positions unless `positions` gives them."""
    b = inp.desc.shape[0] // 2
    d: Dict[str, torch.Tensor] = {}
    d["det_loss"] = det = _det_loss(cfg, inp)
    total = det * cfg.w_det

    # Reliability map fed to the AP loss (nets/losses.py:340-346).
    rel_src = inp.score if cfg.use_pred_score_desc else inp.gt_score
    rel = torch.clamp(torch.clamp(rel_src, 5e-4, 1.0) * 4.0 + 0.5, 5e-4, 1.0)
    d["unsup_desc_loss"] = desc = _unsup_desc_loss(gen, cfg, inp, sampler, rel, b, positions)
    total = total + desc * cfg.w_desc

    if cfg.seg_det and inp.stability is not None:
        d["seg_det_loss"] = sdl = _seg_det_loss(cfg, inp)
        total = total + sdl * cfg.w_seg_det
    if cfg.seg_feat and inp.pred_feats:
        d["seg_feat_loss"] = sfl = _seg_feat_loss(inp)
        total = total + sfl * cfg.w_seg_feat
    if cfg.seg_desc and inp.seg is not None:
        d["seg_desc_loss"] = sdsc = _seg_desc_loss(cfg, inp)
        total = total + sdsc * cfg.w_seg_desc
    d["loss"] = total
    return d
