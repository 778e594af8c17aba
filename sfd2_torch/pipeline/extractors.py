"""Baseline local-feature extractor registry (PyTorch).

Port of ``sfd2_tpu/pipeline/extractors.py`` (``hloc/extractors/`` +
``hloc/utils/base_model.py`` dynamic_load plug-ins):

  sfd2        — the flagship ResSegNetV2 pipeline (``pipeline/extract.py``,
                the fused stem kernel K1 on CUDA)
  superpoint  — SuperPoint detector/descriptor (``hloc/extractors/superpoint.py``)
  r2d2        — Quad_L2Net_ConfCFS reliability×repeatability scoring
  sift        — OpenCV SIFT on the host (``hloc/extractors/sift.py``)
  d2net       — VGG16-conv4_3 dense features + hard detection
  caps        — OpenCV SIFT keypoints (host) + ResUNet coarse‖fine
                descriptors (device, ``caps_describe``)
  sgd2        — L2SegNetNB full-resolution score/descriptors
  dir         — ResNet-101 AP-GeM GLOBAL retrieval descriptor (one [D]
                vector per image, for ``pairs_from_retrieval``)

Each ``make_*(cfg, state_dict=None, device="cuda", seed=0)`` returns a
callable: one float [H, W, 3] image in [0, 1] → ``ImageFeatures`` (``dir``:
→ [D] float32). The image is uploaded once, the network runs under
``torch.inference_mode()``, keypoints are selected on the device and the
result is fetched once. ``state_dict`` takes the port's names (the
converters of ``models/``); without it the weights are drawn from a
``torch.Generator`` seeded with ``seed`` at the JAX package's init scale
(``seeded_init_``). ``sift`` and the CAPS detector need OpenCV and raise
``ImportError`` where it is missing; nothing stands in for it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from sfd2_torch.io.feature_store import ImageFeatures
from sfd2_torch.ops.extract import extract_keypoints
from sfd2_torch.utils.device import resolve_device


@dataclasses.dataclass
class BaselineConfig:
    max_keypoints: int = 2048
    conf_threshold: float = 0.005
    nms_radius: int = 4


# ImageNet normalisation of CAPS and SGD2; caffe BGR mean of D2-Net
# (``d2net.py:43-45``).
_RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)
_CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], np.float32)


def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Random weights at the JAX package's init scale (Flax's defaults:
    kernels normal with variance 1/fan_in, zero biases; BatchNorm
    identity), drawn from a ``torch.Generator`` seeded with `seed`. Zero
    biases keep the ReLU trunks positively homogeneous, so SuperPoint's
    unguarded ``exp`` stays far from overflow at any width."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=gen) * fan_in ** -0.5
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def build_model(model: nn.Module, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                device="cuda", seed: int = 0) -> nn.Module:
    """`model` with `state_dict` (strict) or seeded weights, in eval mode on
    `device` (CUDA unless the caller asks for the CPU; no quiet fallback)."""
    dev = resolve_device(device)
    if state_dict is None:
        seeded_init_(model, seed)
    else:
        model.load_state_dict(state_dict)
    return model.eval().to(dev)


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _topk_from_maps(score_map: torch.Tensor, desc_map: torch.Tensor,
                    cfg: BaselineConfig) -> ImageFeatures:
    """Shared NMS → top-K → descriptor lookup for map-producing baselines,
    on the maps' device; one packed fetch."""
    kp = extract_keypoints(score_map, desc_map, None, max_keypoints=cfg.max_keypoints,
                           conf_threshold=cfg.conf_threshold, nms_radius=cfg.nms_radius)
    packed = torch.cat([kp.xy[0], kp.scores[0, :, None], kp.valid[0, :, None].float(),
                        kp.descriptors[0].float()], dim=-1).cpu().numpy()
    va = packed[:, 3] > 0.5
    return ImageFeatures(packed[va, 0:2], packed[va, 4:], packed[va, 2], None)


def make_superpoint(cfg: BaselineConfig = BaselineConfig(), state_dict=None, device="cuda",
                    seed: int = 0):
    from sfd2_torch.models.superpoint import SuperPoint

    model = build_model(SuperPoint(), state_dict, device, seed)
    dev = next(model.parameters()).device
    gray_w = np.array([0.299, 0.587, 0.114], np.float32)

    @torch.inference_mode()
    def extract(image: np.ndarray) -> ImageFeatures:
        gray = image @ gray_w
        h, w = gray.shape
        buf = np.zeros((1, (h + 7) // 8 * 8, (w + 7) // 8 * 8, 1), np.float32)
        buf[0, :h, :w, 0] = gray
        out = model(_upload(buf, dev))
        return _topk_from_maps(out["scores"], out["descs"], cfg)

    return extract


def make_r2d2(cfg: BaselineConfig = BaselineConfig(), state_dict=None, device="cuda",
              seed: int = 0):
    from sfd2_torch.models.r2d2 import QuadL2NetConfCFS

    model = build_model(QuadL2NetConfCFS(), state_dict, device, seed)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def extract(image: np.ndarray) -> ImageFeatures:
        out = model(_upload(image[None], dev))
        # The full-resolution descriptor map is an NHWC view of the NCHW
        # trunk output; descriptor lookup gathers from it in place.
        return _topk_from_maps(out["reliability"] * out["repeatability"],
                               out["descriptors"], cfg)

    return extract


def _import_cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not installed") from e
    return cv2


def _no_keypoints(dim: int) -> ImageFeatures:
    return ImageFeatures(np.zeros((0, 2), np.float32), np.zeros((0, dim), np.float32),
                         np.zeros(0, np.float32), None)


def make_sift(cfg: BaselineConfig = BaselineConfig(), state_dict=None, device="cuda",
              seed: int = 0):
    """OpenCV SIFT (host only: `state_dict`, `device` and `seed` are
    accepted for the registry's uniform signature and unused)."""
    cv2 = _import_cv2("the sift extractor")
    sift = cv2.SIFT_create(nfeatures=cfg.max_keypoints)

    def extract(image: np.ndarray) -> ImageFeatures:
        gray = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        if gray.ndim == 3:
            gray = cv2.cvtColor(gray, cv2.COLOR_RGB2GRAY)
        kps, desc = sift.detectAndCompute(gray, None)
        if not kps:
            return _no_keypoints(128)
        xy = np.array([k.pt for k in kps], np.float32)
        sc = np.array([k.response for k in kps], np.float32)
        desc = desc.astype(np.float32)
        desc /= np.maximum(np.linalg.norm(desc, axis=1, keepdims=True), 1e-12)
        order = np.argsort(-sc)[: cfg.max_keypoints]
        return ImageFeatures(xy[order], desc[order], sc[order], None)

    return extract


def d2net_select(feats: torch.Tensor, max_keypoints: int):
    """D2-Net keypoints of one [h, w, C] feature map, on its device: the
    hard-detection cells by descending score (ties in row-major order), at
    most `max_keypoints`; descriptors are the L2-normalised feature vectors
    there; positions ×4 + 1.5 (stride 4, ``upscale_positions`` twice).
    Returns [K, 3 + C]: x, y, score, descriptor."""
    from sfd2_torch.models.baselines import d2net_hard_detect

    fired, score = d2net_hard_detect(feats[None])
    ys, xs = torch.nonzero(fired[0], as_tuple=True)
    sc = score[0, ys, xs]
    order = torch.sort(sc, descending=True, stable=True).indices[:max_keypoints]
    ys, xs, sc = ys[order], xs[order], sc[order]
    de = feats[ys, xs]
    de = de / torch.clamp(torch.linalg.norm(de, dim=1, keepdim=True), min=1e-12)
    xy = torch.stack([xs * 4.0 + 1.5, ys * 4.0 + 1.5], -1)
    return torch.cat([xy, sc[:, None], de], dim=-1)


def make_d2net(cfg: BaselineConfig = BaselineConfig(), state_dict=None, device="cuda",
               seed: int = 0):
    """D2-Net (``hloc/extractors/d2net.py``): caffe-normalised BGR input,
    VGG16-conv4_3 dense features (stride 4), hard detection, descriptors =
    L2-normalised feature vectors at the fired cells."""
    from sfd2_torch.models.baselines import D2NetDense

    model = build_model(D2NetDense(use_relu=True), state_dict, device, seed)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def extract(image: np.ndarray) -> ImageFeatures:
        bgr = image[..., ::-1] * 255.0 - _CAFFE_MEAN_BGR
        feats = model(_upload(bgr[None], dev))[0]
        out = d2net_select(feats, cfg.max_keypoints).cpu().numpy()
        return ImageFeatures(out[:, :2], out[:, 3:], out[:, 2], None)

    return extract


def caps_detect(image: np.ndarray, cfg: BaselineConfig = BaselineConfig(), sift=None):
    """CAPS's detector (``caps.py:380-443``): OpenCV SIFT keypoints
    (nOctaveLayers 5, contrast 0.03, edge 8) by descending response, at
    most ``max_keypoints``. Returns (xy [N, 2], scores [N]), host numpy."""
    cv2 = _import_cv2("the caps detector")
    if sift is None:
        sift = cv2.SIFT_create(nOctaveLayers=5, contrastThreshold=0.03, edgeThreshold=8)
    gray = cv2.cvtColor((np.clip(image, 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    kps = sift.detect(gray, None)
    xy = np.array([k.pt for k in kps], np.float32).reshape(-1, 2)
    sc = np.array([k.response for k in kps], np.float32)
    order = np.argsort(-sc)[: cfg.max_keypoints]
    return xy[order], sc[order]


@torch.inference_mode()
def caps_describe(model: nn.Module, image: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """CAPS descriptors at `xy` [N, 2] of one image, on the model's device:
    ImageNet normalisation, ``CapsResUNet``, coarse‖fine sampled at the
    keypoints (``caps_sample_descriptors``). Returns [N, 256] numpy."""
    from sfd2_torch.models.baselines import caps_sample_descriptors

    dev = next(model.parameters()).device
    coarse, fine = model(_upload(((image - _RGB_MEAN) / _RGB_STD)[None], dev))
    return caps_sample_descriptors(coarse[0], fine[0], _upload(xy, dev),
                                   image.shape[:2]).cpu().numpy()


def make_caps(cfg: BaselineConfig = BaselineConfig(), state_dict=None, device="cuda",
              seed: int = 0):
    """CAPS (``hloc/extractors/caps.py:380-443``): ``caps_detect`` on the
    host, then ``caps_describe`` on the device."""
    from sfd2_torch.models.baselines import CapsResUNet

    cv2 = _import_cv2("the caps extractor")
    model = build_model(CapsResUNet(), state_dict, device, seed)
    sift = cv2.SIFT_create(nOctaveLayers=5, contrastThreshold=0.03, edgeThreshold=8)

    def extract(image: np.ndarray) -> ImageFeatures:
        xy, sc = caps_detect(image, cfg, sift)
        if not len(xy):
            return _no_keypoints(256)
        return ImageFeatures(xy, caps_describe(model, image, xy), sc, None)

    return extract


def make_sgd2(cfg: BaselineConfig = BaselineConfig(), state_dict=None, device="cuda",
              seed: int = 0):
    """SGD2 (``hloc/extractors/sgd2.py:850``): L2SegNetNB full-resolution
    sigmoid score + 128-D descriptors, ImageNet normalisation."""
    from sfd2_torch.models.baselines import L2SegNetNB

    model = build_model(L2SegNetNB(outdim=128), state_dict, device, seed)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def extract(image: np.ndarray) -> ImageFeatures:
        score, desc = model(_upload(((image - _RGB_MEAN) / _RGB_STD)[None], dev))
        return _topk_from_maps(score, desc, cfg)

    return extract


def make_dir(cfg: BaselineConfig = BaselineConfig(), state_dict=None, device="cuda",
             seed: int = 0, whiten_pca=None, whiten_params=None, depths=(3, 4, 23, 3)):
    """DIR (``hloc/extractors/dir.py``): ResNet-101 AP-GeM GLOBAL
    descriptor; a callable image → [D] float32 vector. With a `state_dict`
    its depths are the state_dict's. `whiten_pca`: optional (mean,
    components, variances) for dirtorch's PCA power-whitening
    (``dir.py:69-73``)."""
    from sfd2_torch.models.retrieval import DIR_MEAN, DIR_STD, ResNetGeM, pca_whiten, resnet_depths

    if state_dict is not None:
        depths = resnet_depths(state_dict)
        out_dim = state_dict["whiten.weight"].shape[0]
    else:
        out_dim = 2048
    model = build_model(ResNetGeM(depths=tuple(depths), out_dim=out_dim), state_dict, device,
                        seed)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def extract(image: np.ndarray) -> np.ndarray:
        desc = model(_upload(((image - DIR_MEAN) / DIR_STD)[None], dev)).cpu().numpy()
        if whiten_pca is not None:
            desc = pca_whiten(desc, *whiten_pca, **(whiten_params or {}))
        return desc[0].astype(np.float32)

    return extract


def make_sfd2(cfg: BaselineConfig = BaselineConfig(), state_dict=None, device="cuda",
              seed: int = 0, bf16: Optional[bool] = None):
    """SFD2 through the port's ``Extractor`` (the fused stem K1 on CUDA).
    `bf16`: the Extractor's trunk precision (None: bfloat16 on CUDA)."""
    from sfd2_torch.models.sfd2 import ResSegNetV2
    from sfd2_torch.pipeline.extract import ExtractionConfig, Extractor

    if state_dict is None:
        state_dict = seeded_init_(ResSegNetV2(require_stability=True), seed).state_dict()
    ex = Extractor(state_dict, ExtractionConfig(max_keypoints=cfg.max_keypoints,
                                                conf_threshold=cfg.conf_threshold, bf16=bf16),
                   device=device)

    def extract(image: np.ndarray) -> ImageFeatures:
        return ex.extract_batch([image])[0]

    return extract


EXTRACTOR_REGISTRY: Dict[str, Callable] = {
    "sfd2": make_sfd2,
    "superpoint": make_superpoint,
    "r2d2": make_r2d2,
    "sift": make_sift,
    "d2net": make_d2net,
    "caps": make_caps,
    "sgd2": make_sgd2,
}

# Global (whole-image retrieval) extractors — separate registry because
# the output contract differs (one vector per image, no keypoints).
GLOBAL_EXTRACTOR_REGISTRY: Dict[str, Callable] = {
    "dir": make_dir,
}


def reference_state_dict(name: str, path) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (``.pth``) of extractor `name` → the port's
    state_dict for its ``make_*``, through the model's converter."""
    from sfd2_torch.models.convert import convert_ressegnet, load_torch_state_dict
    from sfd2_torch.models.convert_baselines import convert_caps, convert_d2net, convert_l2segnetnb
    from sfd2_torch.models.r2d2 import convert_r2d2
    from sfd2_torch.models.retrieval import convert_dir_resnet
    from sfd2_torch.models.superpoint import convert_superpoint

    converters = {"sfd2": convert_ressegnet, "superpoint": convert_superpoint,
                  "r2d2": convert_r2d2, "d2net": convert_d2net, "caps": convert_caps,
                  "sgd2": convert_l2segnetnb, "dir": convert_dir_resnet}
    if name not in converters:
        raise ValueError(f"extractor {name!r} takes no weights")
    return converters[name](load_torch_state_dict(path))


def dynamic_load(name: str, cfg: Optional[BaselineConfig] = None, **kw):
    """hloc-style loader: name → extract callable (`kw`: ``state_dict``,
    ``device``, ``seed`` and the maker's own options)."""
    if name in EXTRACTOR_REGISTRY:
        return EXTRACTOR_REGISTRY[name](cfg or BaselineConfig(), **kw)
    if name in GLOBAL_EXTRACTOR_REGISTRY:
        return GLOBAL_EXTRACTOR_REGISTRY[name](cfg or BaselineConfig(), **kw)
    raise KeyError(f"unknown extractor {name!r}; have "
                   f"{sorted(EXTRACTOR_REGISTRY) + sorted(GLOBAL_EXTRACTOR_REGISTRY)}")
