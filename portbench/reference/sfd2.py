"""ResSegNetV2 (SFD2's detector and descriptor) and its keypoint extraction,
in plain PyTorch from a state_dict in the reference checkpoint's names.

Network (``nets/sfd2.py`` of github.com/feixue94/sfd2): conv1a, conv1b
(stride 2), bn1b; conv2a, conv2b (stride 2), bn2b; conv3a, conv3b, bn3b;
three bottleneck blocks (1×1, grouped 3×3 with 32 groups, 1×1, identity
skip); the detector head convPa (stride 2) → convPb, 65 channels,
exp-normalised, the dustbin dropped and the 8×8 cells unpacked to full
resolution; the descriptor head convDa → convDb, L2-normalised at 1/4
resolution; the stability head ConvSta, upsampled bilinearly, whose
first-max class gives 0.1, 0.5 or 1.0 and multiplies the score.
BatchNorm is in eval mode (running statistics).

Extraction (hloc's SFD2 extractor, ``nets/extractor.py``): max-pool NMS
of radius 4 with two suppression rounds, scores over 0.001, 4 pixels of
border inside the image's true size, the top 4096 by score, descriptors
sampled bilinearly at the 1/4-resolution map (pixel centres) and
L2-normalised.

``precision``: ``float32`` (the reference; TF32 off) or ``fp8`` (the
control: every convolution's input and weight rounded to float8 e4m3 with
one scale per tensor, products summed in float32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import round_fp8

BN_EPS = 1e-5
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class Net:
    def __init__(self, state_dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.sd = {k: v.float() for k, v in state_dict.items()}
        self.fp8 = precision == "fp8"

    def conv(self, x, name, stride=1, pad=1, groups=1):
        w = self.sd[f"{name}.weight"]
        b = self.sd.get(f"{name}.bias")
        if self.fp8:
            x, w = round_fp8(x), round_fp8(w)
        return F.conv2d(x, w, b, stride, pad, 1, groups)

    def bn(self, x, name):
        mean = self.sd[f"{name}.running_mean"][None, :, None, None]
        var = self.sd[f"{name}.running_var"][None, :, None, None]
        y = (x - mean) / torch.sqrt(var + BN_EPS)
        if f"{name}.weight" in self.sd:
            y = y * self.sd[f"{name}.weight"][None, :, None, None] \
                + self.sd[f"{name}.bias"][None, :, None, None]
        return y

    def forward(self, x):
        """x [B, 3, H, W] normalised → (score [B, H, W] × stability,
        descriptors [B, C, H/4, W/4], stability [B, H, W])."""
        full = x.shape[2:]
        x = F.relu(self.bn(self.conv(x, "conv1a.0"), "conv1a.1"))
        x = F.relu(self.bn(self.conv(x, "conv1b.0", stride=2), "bn1b.0"))
        x = F.relu(self.bn(self.conv(x, "conv2a.0"), "conv2a.1"))
        x = F.relu(self.bn(self.conv(x, "conv2b.0", stride=2), "bn2b.0"))
        x = F.relu(self.bn(self.conv(x, "conv3a.0"), "conv3a.1"))
        x = F.relu(self.bn(self.conv(x, "conv3b.0"), "bn3b.0"))
        for i in range(3):
            p = f"conv4.{i}"
            y = F.relu(self.bn(self.conv(x, f"{p}.conv1", pad=0), f"{p}.bn1"))
            y = F.relu(self.bn(self.conv(y, f"{p}.conv2", groups=32), f"{p}.bn2"))
            y = self.bn(self.conv(y, f"{p}.conv3", pad=0), f"{p}.bn3")
            x = F.relu(y + x)
        pa = F.relu(self.bn(self.conv(x, "convPa.0", stride=2), "convPa.1"))
        semi = torch.exp(self.conv(self.conv(pa, "convPa.3"), "convPb", pad=0))
        semi = semi / (semi.sum(1, keepdim=True) + 1e-5)
        b, _, hc, wc = semi.shape
        score = semi[:, :64].reshape(b, 8, 8, hc, wc).permute(0, 3, 1, 4, 2).reshape(
            b, hc * 8, wc * 8)
        da = F.relu(self.bn(self.conv(x, "convDa.0"), "convDa.1"))
        desc = self.conv(self.conv(da, "convDa.3"), "convDb", pad=0)
        desc = desc / desc.norm(dim=1, keepdim=True).clamp(min=1e-12)
        sta = F.interpolate(self.conv(x, "ConvSta", pad=0), size=tuple(full),
                            mode="bilinear", align_corners=False)
        s0, s1, s2 = sta[:, 0], sta[:, 1], sta[:, 2]
        c0 = (s0 >= s1) & (s0 >= s2)
        c1 = ~c0 & (s1 >= s2)
        stab = torch.where(c0, 0.1, torch.where(c1, 0.5, 1.0))
        if score.shape[1:] != full:
            raise ValueError("image sides must be multiples of 8")
        return score * stab, desc, stab


def normalise(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] → normalised float32 [B, 3, H, W]."""
    x = images_u8.float().permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def nms(scores: torch.Tensor, radius: int, rounds: int = 2) -> torch.Tensor:
    """SuperPoint's max-pool suppression on [B, H, W]."""
    def pool(t):
        return F.max_pool2d(t[:, None], 2 * radius + 1, 1, radius)[:, 0]

    zeros = torch.zeros_like(scores)
    is_max = scores == pool(scores)
    for _ in range(rounds):
        supp = pool(is_max.float()) > 0
        s = torch.where(supp, zeros, scores)
        is_max = is_max | ((s == pool(s)) & ~supp)
    return torch.where(is_max, scores, zeros)


def sample(desc: torch.Tensor, xy: torch.Tensor, full_hw) -> torch.Tensor:
    """desc [C, h, w] at full-resolution pixels xy [N, 2] → [N, C], L2-normalised."""
    c, h, w = desc.shape
    gx = (xy[:, 0] * (w / full_hw[1]) - 0.5 + 0.5) * 2 / w - 1
    gy = (xy[:, 1] * (h / full_hw[0]) - 0.5 + 0.5) * 2 / h - 1
    grid = torch.stack([gx, gy], 1)[None, None]
    d = F.grid_sample(desc[None], grid, mode="bilinear", padding_mode="zeros",
                      align_corners=False)[0, :, 0].T
    return d / d.norm(dim=1, keepdim=True).clamp(min=1e-12)


def keypoints(score: torch.Tensor, desc: torch.Tensor, true_wh, max_keypoints: int,
              conf_threshold: float, nms_radius: int, border: int):
    """One image: score [H, W], desc [C, h, w] → (xy [N, 2], scores [N],
    descriptors [N, C]), by descending score."""
    h, w = score.shape
    s = nms(score[None], nms_radius)[0]
    ys = torch.arange(h, device=s.device)[:, None]
    xs = torch.arange(w, device=s.device)[None, :]
    tw, th = true_wh
    keep = (s > conf_threshold) & (xs >= border) & (xs < tw - border) \
        & (ys >= border) & (ys < th - border)
    flat = torch.where(keep, s, -torch.inf).reshape(-1)
    vals, idx = torch.topk(flat, min(max_keypoints, flat.numel()))
    ok = torch.isfinite(vals)
    vals, idx = vals[ok], idx[ok]
    xy = torch.stack([(idx % w).float(), (idx // w).float()], 1)
    return xy, vals, sample(desc, xy, (h, w))


def logit(p: np.ndarray) -> np.ndarray:
    return np.log(p) - np.log1p(-p)


def compare(prog, ref_net_out, ref_kp) -> dict:
    """The numbers of one image: program (xy, scores, descriptors) against
    the reference's dense outputs (score [H, W], desc [C, h, w], stability
    [H, W]) read at the program's keypoints, and the reference's own
    keypoints.

    ``score_logit_gap``: the median over the program's keypoints of the
    gap between the program's and the reference's detector output in
    logit space, each score divided by the reference's stability factor
    first. The seeded detector's softmax sits near 1 at many keypoints,
    where a relative gap of the score shrinks with 1 − p and hides the
    trunk's rounding; the logit keeps it. Keypoints whose reference
    output float32 cannot tell from 1 (within 1e-5) are left out."""
    xy, sc, de = prog
    score, desc, stab = ref_net_out
    h, w = score.shape
    dev = score.device
    xy_t = torch.from_numpy(np.asarray(xy, np.float32)).to(dev)
    ix = xy_t.long()
    at = (ix[:, 1].clamp(0, h - 1), ix[:, 0].clamp(0, w - 1))
    ref_s = score[at].double().cpu().numpy()
    ref_st = stab[at].double().cpu().numpy()
    ref_d = sample(desc, xy_t, (h, w)).double().cpu().numpy()
    d_gap = np.linalg.norm(np.asarray(de, np.float64) - ref_d, axis=1)
    p_ref = ref_s / ref_st
    p_prog = np.clip(np.asarray(sc, np.float64) / ref_st, 1e-12, 1 - 1e-12)
    ok = (p_ref > 1e-12) & (p_ref < 1 - 1e-5)
    l_gap = np.abs(logit(p_prog[ok]) - logit(p_ref[ok]))
    ref_keys = {(int(x), int(y)) for x, y in np.rint(ref_kp[0]).astype(int)}
    prog_keys = {(int(x), int(y)) for x, y in np.rint(np.asarray(xy)).astype(int)}
    miss = 1.0 - len(ref_keys & prog_keys) / max(len(ref_keys), 1)
    return dict(desc_gap=float(d_gap.max()) if len(d_gap) else 0.0,
                score_logit_gap=float(np.median(l_gap)) if len(l_gap) else 0.0,
                kp_miss_share=float(miss), n_prog=int(len(xy)), n_ref=len(ref_keys),
                n_score=int(ok.sum()))
