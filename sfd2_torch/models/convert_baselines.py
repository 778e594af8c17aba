"""Weight converters of the baseline models (PyTorch).

Port of ``sfd2_tpu/models/convert_baselines.py``, in two directions:

* **Reference checkpoint → the port** (``convert_d2net``,
  ``convert_caps``, ``convert_spd2l2net``, ``convert_l2segnetnb``). The
  port's modules carry the reference networks' names, so these strip the
  wrapper prefixes (D2-Net's ``dense_feature_extraction.``, CAPSNet's
  ``net.``/``net.net.``, ``module.``/``model.``) and cast to float32;
  SuperPoint's, R2D2's and DIR's live beside their models.
* **The JAX package's variables → the port** (``*_from_flax``): one per
  network, the exact inverse of the JAX converters (HWIO kernels → OIHW,
  Flax ``Dense`` [in, out] → torch ``Linear`` [out, in], ``scale``/
  ``mean``/``var`` → ``weight``/``running_mean``/``running_var``), with
  the JAX modules' nested BN names (``_BN`` → ``{name}/bn``, ``_CapsConv``
  → ``conv``/``bnm``). Arrays may be numpy or JAX arrays; nothing of JAX is
  imported.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from sfd2_torch.models.convert import _conv_weight, _strip_prefix, _vec, float_state_dict
from sfd2_torch.models.r2d2 import _l2net_plan, _quad_l2net_plan

# ---------------------------------------------------------------------------
# Reference checkpoints → the port
# ---------------------------------------------------------------------------

# D2-Net's Sequential indices of its convolutions (``DenseFeatureExtractionModule``).
_D2NET_IDX = {
    0: "conv1_1", 2: "conv1_2",
    5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
}


def convert_d2net(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A D2-Net checkpoint (the full model dump,
    ``dense_feature_extraction.model.{i}``, or a bare Sequential dump) →
    the port's ``D2NetDense`` state_dict (``model.{i}``)."""
    sd = _strip_prefix(state)
    pref = ("dense_feature_extraction.model."
            if any(k.startswith("dense_feature_extraction.") for k in sd) else "")
    out: Dict[str, torch.Tensor] = OrderedDict()
    for i in _D2NET_IDX:
        for kind in ("weight", "bias"):
            out[f"model.{i}.{kind}"] = sd[f"{pref}{i}.{kind}"].to(torch.float32).contiguous()
    return out


def convert_caps(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A CAPSNet checkpoint (``net.`` or the wrapper's ``net.net.``) → the
    port's ``CapsResUNet`` state_dict."""
    sd = _strip_prefix(state)
    if any(k.startswith("net.net.") for k in sd):  # CAPSNet wrapper depth
        sd = {k[4:]: v for k, v in sd.items() if k.startswith("net.")}
    if any(k.startswith("net.") for k in sd):
        sd = {k[4:]: v for k, v in sd.items() if k.startswith("net.")}
    return float_state_dict(sd)


def convert_spd2l2net(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An SPD2L2Net checkpoint (``conv1.{i}``, ``convPb``, ``convDb``) →
    the port's state_dict."""
    return float_state_dict(state)


def convert_l2segnetnb(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An L2SegNetNB checkpoint (``conv{1..6}.{i}``, ``convPb``,
    ``convDb``) → the port's state_dict."""
    return float_state_dict(state)


# ---------------------------------------------------------------------------
# The JAX package's variables → the port
# ---------------------------------------------------------------------------


class _Writer:
    """Builds a torch state_dict from Flax entries."""

    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = OrderedDict()

    def conv(self, prefix: str, p: Mapping[str, Any]):
        self.sd[f"{prefix}.weight"] = _conv_weight(p["kernel"])
        if "bias" in p:
            self.sd[f"{prefix}.bias"] = _vec(p["bias"])

    def bn(self, prefix: str, stats: Mapping[str, Any], p: Mapping[str, Any] | None = None):
        if p is not None:
            self.sd[f"{prefix}.weight"] = _vec(p["scale"])
            self.sd[f"{prefix}.bias"] = _vec(p["bias"])
        self.sd[f"{prefix}.running_mean"] = _vec(stats["mean"])
        self.sd[f"{prefix}.running_var"] = _vec(stats["var"])
        self.sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def dense(self, prefix: str, p: Mapping[str, Any]):
        self.sd[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["kernel"], np.float32).T))
        self.sd[f"{prefix}.bias"] = _vec(p["bias"])


def _split(variables: Mapping[str, Any]) -> Tuple[Mapping, Mapping]:
    return variables["params"], variables.get("batch_stats", {})


def superpoint_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``SuperPoint`` variables → the port's (``superpoint_v1`` names)."""
    w = _Writer()
    for name, p in _split(variables)[0].items():
        w.conv(name, p)
    return w.sd


def _dilated_stack_from_flax(w: _Writer, params, stats, plan):
    """``_DilatedStack`` trunk/conv{li}, trunk/bn{li} → ``ops.{i}`` (conv,
    then BN and ReLU where the plan has them)."""
    idx = 0
    for li, (_, _, _, bn, relu) in enumerate(plan):
        w.conv(f"ops.{idx}", params["trunk"][f"conv{li}"])
        idx += 1
        if bn:
            w.bn(f"ops.{idx}", stats["trunk"][f"bn{li}"], params["trunk"].get(f"bn{li}"))
            idx += 1
        idx += int(relu)


def quad_l2net_from_flax(variables: Mapping[str, Any], dim: int = 128,
                         mchan: int = 4) -> Dict[str, torch.Tensor]:
    """Flax ``QuadL2NetConfCFS`` variables → the port's (r2d2 names)."""
    params, stats = _split(variables)
    w = _Writer()
    _dilated_stack_from_flax(w, params, stats, _quad_l2net_plan(dim, mchan))
    w.conv("clf", params["clf"])
    w.conv("sal", params["sal"])
    return w.sd


def l2net_from_flax(variables: Mapping[str, Any], dim: int = 128) -> Dict[str, torch.Tensor]:
    """Flax ``L2Net`` variables → the port's."""
    params, stats = _split(variables)
    w = _Writer()
    _dilated_stack_from_flax(w, params, stats, _l2net_plan(dim))
    return w.sd


def d2net_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``D2NetDense`` variables → the port's (``model.{i}``)."""
    params = _split(variables)[0]
    w = _Writer()
    for i, name in _D2NET_IDX.items():
        w.conv(f"model.{i}", params[name])
    return w.sd


def _blocks(params: Mapping[str, Any], layer: str) -> int:
    return sum(1 for k in params if re.fullmatch(rf"{layer}_\d+", k))


def _bottleneck_from_flax(w: _Writer, prefix: str, p, s, nested_bn: bool):
    """A ResNet bottleneck; the CAPS one nests each BN as ``{name}/bn``."""
    def bn(name):
        return (s[name]["bn"], p[name]["bn"]) if nested_bn else (s[name], p[name])

    for k in (1, 2, 3):
        w.conv(f"{prefix}.conv{k}", p[f"conv{k}"])
        w.bn(f"{prefix}.bn{k}", *bn(f"bn{k}"))
    if "down_conv" in p:
        w.conv(f"{prefix}.downsample.0", p["down_conv"])
        w.bn(f"{prefix}.downsample.1", *bn("down_bn"))


def caps_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``CapsResUNet`` variables (any layer depths) → the port's."""
    params, stats = _split(variables)
    w = _Writer()
    w.conv("firstconv", params["firstconv"])
    w.bn("firstbn", stats["firstbn"]["bn"], params["firstbn"]["bn"])
    for layer in ("layer1", "layer2", "layer3"):
        for i in range(_blocks(params, layer)):
            _bottleneck_from_flax(w, f"{layer}.{i}", params[f"{layer}_{i}"],
                                  stats[f"{layer}_{i}"], nested_bn=True)
    for name, torch_name in (("conv_coarse", "conv_coarse"), ("upconv3", "upconv3.conv"),
                             ("iconv3", "iconv3"), ("upconv2", "upconv2.conv"),
                             ("iconv2", "iconv2"), ("conv_fine", "conv_fine")):
        w.conv(f"{torch_name}.conv", params[name]["conv"])
        w.bn(f"{torch_name}.bn", stats[name]["bnm"]["bn"], params[name]["bnm"]["bn"])
    return w.sd


def _sgd_unit_from_flax(w: _Writer, params, stats, name: str, conv_key: str, bn_key: str):
    w.conv(conv_key, params[name]["conv"])
    w.bn(bn_key, stats[name]["bnm"]["bn"])


def spd2l2net_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``SPD2L2Net`` variables → the port's (``conv1.{i}``)."""
    params, stats = _split(variables)
    w = _Writer()
    for u, ci in enumerate((0, 3, 6, 9, 12, 15, 18, 21, 24, 26)):
        _sgd_unit_from_flax(w, params, stats, f"unit{u}", f"conv1.{ci}", f"conv1.{ci + 1}")
    w.conv("conv1.28", params["tail"])
    w.conv("convPb", params["convPb"])
    w.conv("convDb", params["convDb"])
    return w.sd


def l2segnetnb_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``L2SegNetNB`` variables → the port's (``conv{1..6}.{i}``)."""
    params, stats = _split(variables)
    w = _Writer()
    for stage in ("conv1", "conv2", "conv3", "conv4", "conv5"):
        for u, ci in enumerate((0, 3)):
            _sgd_unit_from_flax(w, params, stats, f"{stage}_{u}", f"{stage}.{ci}",
                                f"{stage}.{ci + 1}")
    for u, ci in enumerate((0, 2)):
        _sgd_unit_from_flax(w, params, stats, f"conv6_{u}", f"conv6.{ci}", f"conv6.{ci + 1}")
    w.conv("conv6.4", params["conv6_tail"])
    w.conv("convPb", params["convPb"])
    w.conv("convDb", params["convDb"])
    return w.sd


def resnet_gem_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``ResNetGeM`` variables (any depths) → the port's (torchvision
    names, ``whiten`` the FC)."""
    params, stats = _split(variables)
    w = _Writer()
    w.conv("conv1", params["conv1"])
    w.bn("bn1", stats["bn1"], params["bn1"])
    li = 1
    while f"layer{li}_0" in params:
        for bi in range(_blocks(params, f"layer{li}")):
            _bottleneck_from_flax(w, f"layer{li}.{bi}", params[f"layer{li}_{bi}"],
                                  stats[f"layer{li}_{bi}"], nested_bn=False)
        li += 1
    w.dense("whiten", params["whiten"])
    return w.sd
