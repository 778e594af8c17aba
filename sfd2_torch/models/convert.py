"""Weights carried across: Flax variables or a reference ``.pth`` → the
port's torch state_dict.

``state_dict_from_flax`` is the exact inverse of
``sfd2_tpu/models/convert.py::convert_ressegnet``: Flax HWIO kernels
become OIHW, ``mean``/``var`` become ``running_mean``/``running_var``, and
names are the reference checkpoint's torch names (the key table is in
that module's docstring), so a reference ``.pth`` and a converted Flax
tree load into ``ResSegNetV2`` the same way. The stem's BN-folded kernel
weights are derived from this state_dict by
``sfd2_torch/ops/stem.py::repack_stem_params``.

``convert_checkpoint`` reads a reference checkpoint (the shipped
``weights/20220810_ressegnetv2_wapv2_ce_sd2mfsf_uspg.pth``, which
``extract_localization.py:208`` loads as ``ckpt['model']``) straight into
that state_dict, through ``convert_ressegnet``'s own copy of the key
table.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _conv_weight(kernel) -> torch.Tensor:
    """HWIO → OIHW (grouped convs share the transpose)."""
    return torch.from_numpy(np.array(np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1)),
                                     order="C"))


def _vec(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} (arrays) of the Flax ResSegNet[V2] → the
    port's (and the reference's) torch state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = OrderedDict()

    def bn(prefix: str, st, p=None):
        if p is not None:
            sd[f"{prefix}.weight"] = _vec(p["scale"])
            sd[f"{prefix}.bias"] = _vec(p["bias"])
        sd[f"{prefix}.running_mean"] = _vec(st["mean"])
        sd[f"{prefix}.running_var"] = _vec(st["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def conv(prefix: str, p, bias: bool = True):
        sd[f"{prefix}.weight"] = _conv_weight(p["kernel"])
        if bias:
            sd[f"{prefix}.bias"] = _vec(p["bias"])

    for stage in (1, 2, 3):
        a, b, n = f"conv{stage}a", f"conv{stage}b", f"bn{stage}b"
        conv(f"{a}.0", params[a]["conv"])
        bn(f"{a}.1", stats[a]["bn"])
        conv(f"{b}.0", params[b]["conv"])
        bn(f"{n}.0", stats[n]["bn"])
    for i in range(3):
        p, s = params[f"res{i+1}"], stats[f"res{i+1}"]
        for j in (1, 2, 3):
            conv(f"conv4.{i}.conv{j}", p[f"conv{j}"], bias=False)
            bn(f"conv4.{i}.bn{j}", s[f"bn{j}"], p[f"bn{j}"])
    for head in ("convPa", "convDa"):
        conv(f"{head}.0", params[head]["conv0"])
        bn(f"{head}.1", stats[head]["bn"], params[head]["bn"])
        conv(f"{head}.3", params[head]["conv1"])
    conv("convPb", params["convPb"])
    conv("convDb", params["convDb"])
    if "convSta" in params:
        conv("ConvSta", params["convSta"])
    return sd


def _strip_prefix(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = OrderedDict()
    for k, v in state.items():
        for pre in ("module.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = torch.as_tensor(v)
    return out


def float_state_dict(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference state_dict whose names are already the port's: prefixes
    stripped, float32 tensors (the BN counters int64)."""
    return OrderedDict(
        (k, v.to(torch.long if k.endswith("num_batches_tracked") else torch.float32).contiguous())
        for k, v in _strip_prefix(state).items())


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """Load a reference checkpoint (.pth, ``ckpt['model']``,
    ``ckpt['state_dict']`` or a bare state_dict) on the CPU, with the ``module.``/``model.`` prefixes
    stripped. Tensors only (``weights_only``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):  # SFD2 / D2-Net; r2d2
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
    return _strip_prefix(ckpt)


def _ressegnet_keys(has_stability: bool):
    """The reference ResSegNetV2's parameter and buffer names, by unit (the
    key table above): the names ``ResSegNetV2.load_state_dict`` takes."""
    bn_stats = ("running_mean", "running_var", "num_batches_tracked")
    keys = []
    for stage in (1, 2, 3):
        keys += [f"conv{stage}a.0.weight", f"conv{stage}a.0.bias"]
        keys += [f"conv{stage}a.1.{b}" for b in bn_stats]
        keys += [f"conv{stage}b.0.weight", f"conv{stage}b.0.bias"]
        keys += [f"bn{stage}b.0.{b}" for b in bn_stats]
    for i in range(3):
        for j in (1, 2, 3):
            keys.append(f"conv4.{i}.conv{j}.weight")
            keys += [f"conv4.{i}.bn{j}.{b}" for b in ("weight", "bias", *bn_stats)]
    for head in ("convPa", "convDa"):
        keys += [f"{head}.0.weight", f"{head}.0.bias"]
        keys += [f"{head}.1.{b}" for b in ("weight", "bias", *bn_stats)]
        keys += [f"{head}.3.weight", f"{head}.3.bias"]
    keys += ["convPb.weight", "convPb.bias", "convDb.weight", "convDb.bias"]
    if has_stability:
        keys += ["ConvSta.weight", "ConvSta.bias"]
    return keys


def convert_ressegnet(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference ResSegNet[V2] state_dict (prefixes stripped or not) →
    the port's: float32 tensors under the key table's names, the BN
    counters int64 (0 where the checkpoint has none). Keys outside the
    table are dropped, as the reference's ``strict=False`` load drops
    them; a missing key raises ``KeyError``."""
    sd = _strip_prefix(state)
    out: Dict[str, torch.Tensor] = OrderedDict()
    for key in _ressegnet_keys("ConvSta.weight" in sd):
        if key.endswith("num_batches_tracked"):
            out[key] = sd.get(key, torch.tensor(0)).to(torch.long).reshape(())
        elif key not in sd:
            raise KeyError(f"reference checkpoint lacks {key}")
        else:
            out[key] = sd[key].to(torch.float32).contiguous()
    return out


def convert_checkpoint(path) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` → the port's ResSegNetV2 state_dict."""
    return convert_ressegnet(load_torch_state_dict(path))
