"""Shared conv/BN building blocks (NCHW, the reference's torch names).

Port of ``sfd2_tpu/models/layers.py``. The modules are laid out as the
reference network's ``nn.Sequential`` stacks (``nets/sfd2.py:14-96``) so a
reference ``state_dict`` loads by name: ``ConvUnit`` is
``[Conv2d, BatchNorm2d(affine=False), ReLU]`` (indices 0/1/2),
``ConvBNReluConv`` is ``[Conv2d, BatchNorm2d, ReLU, Conv2d]``. Padding is
torch's symmetric ``padding=p``, which is what the JAX package emulates
with explicit ``((p, p), (p, p))``. The grouped 3×3 conv of ``ResBlock``
is ``GroupedConvAsDense``: an ``nn.Conv2d`` with the grouped weight
``[C, C/g, 3, 3]`` (the reference's ``state_dict`` name and layout) whose
``forward`` is cuDNN's native ``groups=g`` conv, the faster form on the
H100 (``PERF.md`` §6), and whose ``coarse`` method is the JAX package's
form: a conv over C/128 coarse groups whose kernels are block-diagonal.

Every BatchNorm is ``BatchNorm2d`` with Flax's running-variance rule (see
that class): in train mode it normalises with the batch statistics and
moves the running variance towards the *biased* batch variance, as
``flax.linen.BatchNorm`` does.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention; Flax's 0.9 (sfd2_tpu/models/layers.py:24)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of ``running_var`` uses the
    biased batch variance (``flax/linen/normalization.py``), where torch's
    uses the unbiased one, n/(n−1) times larger. Normalisation, momentum
    and the state_dict names (``running_mean``, ``running_var``,
    ``num_batches_tracked``) are torch's, so a trained model loads into
    ``Extractor`` and ``repack_stem_params`` unchanged. Eval mode is
    ``nn.BatchNorm2d``'s."""

    def __init__(self, num_features: int, affine: bool = True):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvUnit(nn.Sequential):
    """Conv2d (+ optional affine-free BN) (+ optional ReLU) — ``conv()``
    of the reference."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, use_bn: bool = True, relu: bool = True):
        layers = [nn.Conv2d(cin, cout, kernel, stride, padding=padding)]
        if use_bn:
            layers.append(BatchNorm2d(cout, affine=False))
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class BNRelu(nn.Sequential):
    """Affine-free BatchNorm + optional ReLU — ``batch_normalization()``."""

    def __init__(self, channels: int, relu: bool = True):
        layers = [BatchNorm2d(channels, affine=False)]
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class _GroupedConvNCHWWeightGrad(torch.autograd.Function):
    """`conv`'s grouped conv of x, forward and input gradient as autograd
    runs them on x's layout, the weight gradient on NCHW copies. The trunk's
    activations are channels-last views of its NHWC input, and there cuDNN's
    f32 grouped weight gradient takes about 8× its NCHW time at the train
    step's shape (``PERF.md`` §6). The forward stays the in-place conv, so
    the activations, and every decision taken on them, are unchanged."""

    @staticmethod
    def forward(ctx, x, weight, conv):
        ctx.save_for_backward(x, weight)
        ctx.conf = (conv.stride, conv.padding, conv.dilation, conv.groups)
        return F.conv2d(x, weight, None, *ctx.conf)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        args = (None, stride, padding, dilation, False, (0, 0), groups)
        grad_x = grad_w = None
        if ctx.needs_input_grad[0]:
            grad_x = torch.ops.aten.convolution_backward(
                grad, x, weight, *args, (True, False, False))[0]
        if ctx.needs_input_grad[1]:
            grad_w = torch.ops.aten.convolution_backward(
                grad.contiguous(), x.contiguous(), weight, *args, (False, True, False))[1]
        return grad_x, grad_w, None


class GroupedConvAsDense(nn.Conv2d):
    """Grouped 3×3 conv (padding 1, no bias) —
    ``sfd2_tpu/models/layers.py::GroupedConvAsDense``.

    ``forward`` is cuDNN's native groups=g conv on `x` as it is laid out;
    where autograd takes the weight's gradient, that gradient runs on NCHW
    copies of `x` and of the output's gradient
    (``_GroupedConvNCHWWeightGrad``). ``coarse(x)`` is the JAX module's
    form of the same conv: a groups=g conv over C channels is exactly a conv
    over C/128 coarse groups whose per-group kernels are block-diagonal
    (off-group weights zero), when the fine groups nest in 128-channel
    ones; otherwise one dense group. The one parameter stays the grouped
    ``weight`` [C, C/g, 3, 3]; ``coarse`` scatters it into the coarse kernel
    [C, C/coarse, 3, 3] through an index buffer, so autograd carries the
    gradient back into the grouped weight only (the zero blocks are not
    parameters)."""

    def __init__(self, channels: int, groups: int, stride: int = 1):
        super().__init__(channels, channels, 3, stride, 1, groups=groups, bias=False)
        group_in = channels // groups
        # Coarsest 128-aligned grouping, the rule of the JAX module.
        self.coarse_groups = (channels // 128
                              if channels % 128 == 0 and 128 % group_in == 0 else 1)
        cg_in = channels // self.coarse_groups
        # Output channel o reads input rows (o // g_in)·g_in … + g_in, taken
        # relative to its coarse group's first channel.
        rows = (torch.arange(channels) // group_in) * group_in % cg_in
        self.register_buffer("_index", rows[:, None] + torch.arange(group_in),
                             persistent=False)

    def dense_weight(self) -> torch.Tensor:
        """The coarse block-diagonal kernel [C, C/coarse, 3, 3]."""
        w = self.weight
        index = self._index[:, :, None, None].expand_as(w)
        cg_in = self.out_channels // self.coarse_groups
        return w.new_zeros(self.out_channels, cg_in, 3, 3).scatter(1, index, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and self.weight.requires_grad:
            return _GroupedConvNCHWWeightGrad.apply(x, self.weight, self)
        return super().forward(x)

    def coarse(self, x: torch.Tensor) -> torch.Tensor:
        """The conv over ``coarse_groups`` block-diagonal groups."""
        return F.conv2d(x, self.dense_weight(), None, self.stride, self.padding, 1,
                        self.coarse_groups)


class ResBlock(nn.Module):
    """1×1 → grouped 3×3 → 1×1 bottleneck with identity skip
    (``nets/sfd2.py:25-55``; groups=32, bias-free convs, affine BNs)."""

    def __init__(self, planes: int, groups: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = GroupedConvAsDense(planes, groups)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes, 1, bias=False)
        self.bn3 = BatchNorm2d(planes)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + x)


class ConvBNReluConv(nn.Sequential):
    """Conv(3×3, maybe stride 2) → affine BN → ReLU → Conv(3×3) — the
    ``convPa`` / ``convDa`` heads (``nets/sfd2.py:286-297``)."""

    def __init__(self, cin: int, cout: int, first_stride: int = 1):
        super().__init__(
            nn.Conv2d(cin, cout, 3, first_stride, padding=1),
            BatchNorm2d(cout),
            nn.ReLU(),
            nn.Conv2d(cout, cout, 3, 1, padding=1),
        )
