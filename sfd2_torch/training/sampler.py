"""Query/positive/negative sampling on dense descriptor maps.

Port of ``sfd2_tpu/training/sampler.py`` — the ``nets/sampler.py`` family:
* ``NghSampler2DS:537``, the sampler the shipped config trains with
  (ngh=7, subq=−4 random queries, pos_d=3, neg_d=5, border=8, subd_neg=−4
  distractors, maxpool_pos, scaling_step=2), and ``NghSampler2:264`` with
  the seg-aware distractor masking of ``forward2:434-447``;
* ``FullSampler:28`` (``warp_to_img1``), ``SubSampler:82``,
  ``NghSampler:149``, ``FarNearSampler:204``;
* the position up/downscale helpers (``nets/sampler.py:16-25``).

Every set has a static size derived from the map dims (Nq queries per
image, P positive and Nn negative ring offsets, Nd distractors); invalid
flow targets are masked, not filtered. All samplers return
``SampledScores``. The random query and distractor positions of the
``NghSampler2*`` family are drawn from a ``torch.Generator`` on the maps'
device (``sample_positions``); ``positions=`` takes them from outside
instead, which is how the tests feed the positions ``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from sfd2_torch.ops.grid_sample import sample_at_points
from sfd2_torch.utils.device import to_device


def upscale_positions(pos, scaling_steps: int = 0):
    for _ in range(scaling_steps):
        pos = pos * 2 + 0.5
    return pos


def downscale_positions(pos, scaling_steps: int = 0):
    for _ in range(scaling_steps):
        pos = (pos - 0.5) / 2
    return pos


class SampledScores(NamedTuple):
    scores: torch.Tensor  # [N, M] similarity rows (pos | neg | distractors)
    gt: torch.Tensor  # [N, M] binary labels (1 = positive column)
    mask: torch.Tensor  # [N] valid query rows
    qconf: torch.Tensor  # [N] reliability at query positions
    col_weights: torch.Tensor  # [N, M] 1 for live columns, 0 for suppressed


class Positions(NamedTuple):
    """Query (x1, y1) and distractor (x3, y3) positions on the descriptor
    grid, [B, Nq] / [B, Nd] int64; x3/y3 None without distractors."""

    x1: torch.Tensor
    y1: torch.Tensor
    x3: Optional[torch.Tensor] = None
    y3: Optional[torch.Tensor] = None


def _up_idx(pos: torch.Tensor, steps: int, extent: int) -> torch.Tensor:
    return upscale_positions(pos.float(), steps).long().clamp(0, extent - 1)


@dataclasses.dataclass(frozen=True)
class NghSampler2DS:
    ngh: int = 7
    subq: int = -4
    subd: int = 1
    pos_d: int = 3
    neg_d: int = 5
    border: int = 8
    subd_neg: int = -4
    maxpool_pos: bool = True
    scaling_step: int = 2

    def offsets(self):
        """Pos/neg ring offsets (``nets/sampler.py:292-309``), (dx, dy)."""
        rad = (self.ngh // self.subd) * self.ngh
        pos, neg = [], []
        for j in range(-rad, rad + 1, self.subd):
            for i in range(-rad, rad + 1, self.subd):
                d2 = i * i + j * j
                if d2 <= self.pos_d**2:
                    pos.append((i, j))
                elif self.neg_d**2 <= d2 <= self.ngh**2:
                    neg.append((i, j))
        return np.array(pos, np.int64), np.array(neg, np.int64)

    def num_queries(self, h: int, w: int) -> int:
        step = abs(self.subq)
        return max(1, ((h - 2 * self.border) * (w - 2 * self.border)) // step**2)

    def sample_positions(self, gen: torch.Generator, b: int, h: int, w: int) -> Positions:
        """Random queries (subq < 0) and distractors (subd_neg ≠ 0) from
        `gen`, on its device; a strided grid of queries for subq > 0."""
        dev = gen.device

        def draw(n, hi, lo):
            return torch.randint(lo, hi, (b, n), generator=gen, device=dev)

        bd = self.border
        if self.subq < 0:
            nq = self.num_queries(h, w)
            x1, y1 = draw(nq, w - bd, bd), draw(nq, h - bd, bd)
        else:
            ys = torch.arange(bd, h - bd, self.subq, device=dev)
            xs = torch.arange(bd, w - bd, self.subq, device=dev)
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            x1 = gx.reshape(1, -1).expand(b, -1)
            y1 = gy.reshape(1, -1).expand(b, -1)
        x3 = y3 = None
        if self.subd_neg:
            nd = self.num_queries(h, w)
            x3, y3 = draw(nd, w - bd, bd), draw(nd, h - bd, bd)
        return Positions(x1, y1, x3, y3)

    def __call__(self, gen, feat1, feat2, conf1, conf2, aflow, seg1=None, seg2=None,
                 positions: Optional[Positions] = None) -> SampledScores:
        """feat1/feat2 [B, h, w, D] descriptor maps, conf1/conf2 [B, H, W]
        full-res reliabilities, aflow [B, H, W, 2] img1→img2 (NaN invalid),
        seg1/seg2 [B, H, W] labels (forward2), `positions` or `gen`."""
        b, h, w, _ = feat1.shape
        hf, wf = conf1.shape[1], conf1.shape[2]
        dev = feat1.device
        if positions is None:
            positions = self.sample_positions(gen, b, h, w)
        x1, y1 = positions.x1.to(dev).long(), positions.y1.to(dev).long()
        pos_np, neg_np = self.offsets()
        pos_off, neg_off = to_device(pos_np, dev), to_device(neg_np, dev)
        st = self.scaling_step

        bidx = torch.arange(b, device=dev)[:, None]
        feat1_s = feat1[bidx, y1, x1]  # [B, Nq, D]
        y1_up, x1_up = _up_idx(y1, st, hf), _up_idx(x1, st, wf)
        qconf = conf1[bidx, y1_up, x1_up]

        # Ground-truth positions in image 2 (desc grid).
        flow = aflow[bidx, y1_up, x1_up]  # [B, Nq, 2] full-res (x, y)
        flow_ok = torch.isfinite(flow).all(-1)
        flow = torch.where(flow_ok[..., None], flow, -1e6)
        xy2_up = torch.floor(flow + 0.5)
        xy2 = torch.floor(downscale_positions(xy2_up, st)).long()
        x2, y2 = xy2[..., 0], xy2[..., 1]
        mask = flow_ok & (x2 >= 0) & (y2 >= 0) & (x2 < w) & (y2 < h)

        def gather2(ys, xs):
            return feat2[bidx[..., None], ys.clamp(0, h - 1), xs.clamp(0, w - 1)]

        # Positives: ring ≤ pos_d around the target, max-pooled to one score.
        yp = y2[..., None] + pos_off[:, 1]
        xp = x2[..., None] + pos_off[:, 0]
        pscores = torch.einsum("bqd,bqkd->bqk", feat1_s, gather2(yp, xp))
        if self.maxpool_pos:
            pbest = pscores.argmax(-1, keepdim=True)
            pscores = pscores.max(-1, keepdim=True).values
            # qconf ← average with conf2 at the selected positive.
            sel_x = (x2 + pos_off[:, 0][pbest[..., 0]]).clamp(0, w - 1)
            sel_y = (y2 + pos_off[:, 1][pbest[..., 0]]).clamp(0, h - 1)
            qconf = (qconf + conf2[bidx, _up_idx(sel_y, st, hf), _up_idx(sel_x, st, wf)]) / 2

        # Negatives: ring neg_d..ngh.
        yn = y2[..., None] + neg_off[:, 1]
        xn = x2[..., None] + neg_off[:, 0]
        nscores = torch.einsum("bqd,bqkd->bqk", feat1_s, gather2(yn, xn))

        parts = [pscores, nscores]
        col_w_parts = [torch.ones_like(pscores), torch.ones_like(nscores)]
        if self.subd_neg:
            x3, y3 = positions.x3.to(dev).long(), positions.y3.to(dev).long()
            nd = x3.shape[1]
            distr = feat2[bidx, y3, x3].reshape(b * nd, feat2.shape[-1])
            dscores = torch.einsum("bqd,md->bqm", feat1_s, distr)  # [B, Nq, B*Nd]
            # Distractors that are positives (same image, within neg_d of the
            # target) get column weight 0.
            x3f, y3f = x3.reshape(-1), y3.reshape(-1)
            b3 = torch.arange(b, device=dev).repeat_interleave(nd)
            dis2 = (x3f - x2[..., None]) ** 2 + (y3f - y2[..., None]) ** 2
            dis2 = dis2 + (b3 != bidx[..., None]).long() * self.neg_d**2
            if seg1 is not None and seg2 is not None:
                # forward2: a near distractor with another label than the
                # query's stays a negative.
                seg_q = seg1[bidx, y1_up, x1_up]
                seg_d = seg2[b3, _up_idx(y3f, st, hf), _up_idx(x3f, st, wf)]
                dis2 = dis2 + (seg_q[..., None] != seg_d).long() * self.neg_d**2
            live = (dis2 >= self.neg_d**2).to(feat1.dtype)
            parts.append(dscores * live)
            col_w_parts.append(live)

        scores = torch.cat(parts, -1)
        col_w = torch.cat(col_w_parts, -1)
        gt = torch.zeros_like(scores)
        gt[..., : pscores.shape[-1]] = 1.0
        n, m = scores.shape[0] * scores.shape[1], scores.shape[-1]
        return SampledScores(scores.reshape(n, m), gt.reshape(n, m), mask.reshape(n),
                             qconf.reshape(n), col_w.reshape(n, m))


@dataclasses.dataclass(frozen=True)
class NghSampler2(NghSampler2DS):
    """``NghSampler2`` (``nets/sampler.py:264``): the same scheme at one
    resolution (no up/downscale); seg1/seg2 turn on forward2's masking."""

    scaling_step: int = 0


# ---------------------------------------------------------------------------
# Warp-based samplers (FullSampler / SubSampler / NghSampler / FarNear)
# ---------------------------------------------------------------------------


def warp_to_img1(feat2: torch.Tensor, aflow: torch.Tensor):
    """``FullSampler._warp`` (``nets/sampler.py:49-66``): sample img2's map
    bilinearly at img1's flow targets. feat2 [B, h, w, C], aflow
    [B, h, w, 2] (same resolution) → (feat2to1 [B,h,w,C], in-bounds finite
    flow mask [B,h,w])."""
    b, h, w, c = feat2.shape
    gx, gy = aflow[..., 0], aflow[..., 1]
    ok = (torch.isfinite(gx) & torch.isfinite(gy)
          & (gx >= 0) & (gy >= 0) & (gx <= w - 1) & (gy <= h - 1))
    pts = torch.where(ok[..., None], aflow, 0.0)
    warped = torch.stack([sample_at_points(feat2[i], pts[i].reshape(-1, 2), "zeros")
                          for i in range(b)]).reshape(b, h, w, c)
    return torch.where(ok[..., None], warped, 0.0), ok


def _grid_idx(border: int, step: int, h: int, w: int, device):
    ys = np.arange(border, h - border, step)
    xs = np.arange(border, w - border, step)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return to_device(gy.reshape(-1), device), to_device(gx.reshape(-1), device)


def _warp_conf(conf2, aflow):
    return warp_to_img1(conf2[..., None], aflow)[0][..., 0] if conf2 is not None else None


@dataclasses.dataclass(frozen=True)
class SubSampler:
    """``SubSampler`` (``nets/sampler.py:82``): strided queries of img1
    against the same-strided grid of the flow-warped img2 over the whole
    batch ([B·Nq, B·Nd] scores); ground truth = pixel-index equality."""

    border: int = 16
    subq: int = 8
    subd: int = 8

    def __call__(self, gen, feat1, feat2, conf1, conf2, aflow, seg1=None, seg2=None,
                 positions=None) -> SampledScores:
        b, h, w, d = feat1.shape
        dev = feat1.device
        feat2to1, ok2 = warp_to_img1(feat2, aflow)
        conf2to1 = _warp_conf(conf2, aflow)
        yq, xq = _grid_idx(self.border, self.subq, h, w, dev)
        yd, xd = _grid_idx(self.border, self.subd, h, w, dev)
        bidx = torch.arange(b, device=dev)[:, None]
        q = feat1[bidx, yq, xq].reshape(b * yq.numel(), d)
        db = feat2to1[bidx, yd, xd].reshape(b * yd.numel(), d)
        scores = q @ db.T
        idx_q = (bidx * (h * w) + yq * w + xq).reshape(-1)
        idx_d = (bidx * (h * w) + yd * w + xd).reshape(-1)
        gt = (idx_q[:, None] == idx_d[None, :]).to(scores.dtype)
        mask = ok2[bidx, yq, xq].reshape(-1)
        if conf1 is not None and conf2to1 is not None:
            qconf = (conf1[bidx, yq, xq] + conf2to1[bidx, yq, xq]).reshape(-1) / 2
        else:
            qconf = torch.ones_like(mask, dtype=feat1.dtype)
        return SampledScores(scores, gt, mask, qconf, torch.ones_like(scores))


@dataclasses.dataclass(frozen=True)
class FullSampler(SubSampler):
    """``FullSampler`` (``nets/sampler.py:28-81``): every pixel of img1
    against every flow-warped pixel of img2 (unit stride, no border).
    Quadratic in pixels: small crops only."""

    border: int = 0
    subq: int = 1
    subd: int = 1


def make_sampler(name: str, **kwargs):
    """Sampler registry for config/CLI selection (the reference builds
    samplers through its eval() DSL, ``train.py:195``)."""
    table = {
        "ngh2ds": NghSampler2DS,
        "ngh2": NghSampler2,
        "full": FullSampler,
        "sub": SubSampler,
        "ngh": NghSampler,
        "farnear": FarNearSampler,
    }
    if name not in table:
        raise ValueError(f"unknown sampler {name!r}; choose from {sorted(table)}")
    return table[name](**kwargs)


def _ring_offsets(ngh: int, subd: int, ignore: int):
    """Offsets with ignore² < i²+j² ≤ ngh² (``nets/sampler.py:185-195``)."""
    rad = (ngh // subd) * ngh
    out = []
    for j in range(-rad, rad + 1, subd):
        for i in range(-rad, rad + 1, subd):
            if ignore**2 < i * i + j * j <= ngh**2:
                out.append((i, j))
    return np.array(out, np.int64)


@dataclasses.dataclass(frozen=True)
class NghSampler:
    """``NghSampler`` (``nets/sampler.py:149``): per strided query of img1,
    the positive is the warped img2 at the same position, the negatives
    the warped img2 at ring offsets ignore < r ≤ ngh."""

    ngh: int = 4
    subq: int = 1
    subd: int = 1
    ignore: int = 1
    border: int | None = None

    def __call__(self, gen, feat1, feat2, conf1, conf2, aflow, seg1=None, seg2=None,
                 positions=None) -> SampledScores:
        b, h, w, d = feat1.shape
        dev = feat1.device
        border = self.border if self.border is not None else self.ngh
        feat2to1, ok2 = warp_to_img1(feat2, aflow)
        conf2to1 = _warp_conf(conf2, aflow)
        yq, xq = _grid_idx(border, self.subq, h, w, dev)
        off = to_device(_ring_offsets(self.ngh, self.subd, self.ignore), dev)
        bidx = torch.arange(b, device=dev)[:, None]
        q = feat1[bidx, yq, xq]  # [B, Nq, D]
        yo = (yq[:, None] + off[:, 1]).clamp(0, h - 1)
        xo = (xq[:, None] + off[:, 0]).clamp(0, w - 1)
        center = (q * feat2to1[bidx, yq, xq]).sum(-1, keepdim=True)
        ring = torch.einsum("bqd,bqkd->bqk", q, feat2to1[bidx[..., None], yo, xo])
        scores = torch.cat([center, ring], -1)
        gt = torch.zeros_like(scores)
        gt[..., 0] = 1.0
        mask = ok2[bidx, yq, xq]
        if conf1 is not None and conf2to1 is not None:
            qconf = (conf1[bidx, yq, xq] + conf2to1[bidx, yq, xq]) / 2
        else:
            qconf = torch.ones_like(mask, dtype=feat1.dtype)
        n, m = b * yq.numel(), scores.shape[-1]
        return SampledScores(scores.reshape(n, m), gt.reshape(n, m), mask.reshape(n),
                             qconf.reshape(n), torch.ones(n, m, dtype=feat1.dtype, device=dev))


@dataclasses.dataclass(frozen=True)
class FarNearSampler:
    """``FarNearSampler`` (``nets/sampler.py:204``): negatives from a close
    ring (NghSampler) and a far batch-wide grid (SubSampler);
    `maxpool_ngh` collapses the close block to its max as the positive."""

    subq: int = 8
    ngh: int = 4
    subd_ngh: int = 1
    subd_far: int = 16
    border: int | None = None
    ignore: int = 1
    maxpool_ngh: bool = False

    def __call__(self, gen, feat1, feat2, conf1, conf2, aflow, seg1=None, seg2=None,
                 positions=None) -> SampledScores:
        border = self.border if self.border is not None else self.ngh
        close = NghSampler(ngh=self.ngh, subq=self.subq, subd=self.subd_ngh,
                           ignore=0 if self.maxpool_ngh else self.ignore,
                           border=border)(gen, feat1, feat2, conf1, conf2, aflow)
        far = SubSampler(border=border, subq=self.subq, subd=self.subd_far)(
            gen, feat1, feat2, conf1, conf2, aflow)
        s1, g1 = close.scores, close.gt
        if self.maxpool_ngh:
            s1 = s1.max(1, keepdim=True).values
            g1 = g1[:, 0:1]
        return SampledScores(
            scores=torch.cat([s1, far.scores], 1), gt=torch.cat([g1, far.gt], 1),
            mask=close.mask, qconf=close.qconf,
            col_weights=torch.cat([torch.ones_like(s1), far.col_weights], 1))
