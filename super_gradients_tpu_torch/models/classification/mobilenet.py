"""MobileNet V1 / V2 / V3, NCHW (counterpart of
``super_gradients_tpu/models/classification/mobilenet.py``).

Attribute names are the original super-gradients ones, so that
``conversion/from_jax.py``'s ``MOBILENET_V{1,2,3}_RULES`` carry the JAX variables across
and a ``.pth`` of the original layout loads:

- V2 and V3: ``features.0`` the stem ``Sequential(conv, bn, act)``, ``features.{i + 1}`` the
  inverted-residual blocks, each a ``conv`` ``Sequential``; V2's ``features.18`` is the
  1x1 head conv and ``classifier`` ``Sequential(dropout, linear)``; V3's head conv is
  ``conv`` and ``classifier`` ``Sequential(linear, hardswish, dropout, linear)``.
- An inverted-residual block with an expansion is ``[pw, bn, act, dw, bn, act, pwl, bn]``
  (V2) or ``[pw, bn, act, dw, bn, SE, act, pwl, bn]`` (V3: squeeze-excitation between the
  depthwise BN and its activation); without one ``[dw, bn, act, pwl, bn]`` (V2) or
  ``[dw, bn, act, SE, pwl, bn]`` (V3). A V3 block without SE keeps an ``Identity`` in its
  place, so the indices stay fixed.
- V1: ``conv1`` / ``bn1`` stem, ``layers.N.{conv1, bn1, conv2, bn2}`` (depthwise, then
  pointwise), a 2x2 average pool, a flatten and ``linear``, sized from ``input_hw`` (64x64,
  the size at which the JAX module sizes its ``Dense``).

The hidden widths follow the JAX arithmetic: ``_make_divisible(cin * expand_ratio)``, where
V3 passes the float ratio ``_make_divisible(exp * width_mult) / cin``. BatchNorms use
torch's momentum 0.1 (flax 0.9) and eps 1e-5. Dropout draws its masks from a seeded
generator (:class:`SeededDropout`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.segmentation.stdc import SeededDropout
from super_gradients_tpu_torch.modules.blocks import SEBlock, get_activation


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1):
    return [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False), nn.BatchNorm2d(cout)]


def conv_bn_act(cin: int, cout: int, kernel: int, stride: int, act: str) -> nn.Sequential:
    """``Sequential(conv, bn, act)``: a stem or head conv of V2 / V3."""
    return nn.Sequential(*_conv_bn(cin, cout, kernel, stride), get_activation(act))


class InvertedResidual(nn.Module):
    """The MBConv block: an optional 1x1 expansion, the depthwise ``kernel`` conv (with SE
    where ``se_ratio`` is given), the 1x1 projection, and the residual where the stride is 1
    and the width is kept. ``se_before_act`` (V3) puts SE between the depthwise BN and its
    activation in an expanding block; ``tap_expand`` also returns the expanded features
    after their activation (SSD-lite's tap of ``features.14.conv.2``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, expand_ratio: float, kernel: int = 3,
                 act: str = "relu6", se_ratio: Optional[float] = None, se_before_act: bool = False,
                 tap_expand: bool = False):
        super().__init__()
        expanded = expand_ratio != 1
        hidden = _make_divisible(in_channels * expand_ratio) if expanded else in_channels
        self.use_residual = stride == 1 and in_channels == out_channels
        self.tap_expand = tap_expand
        se = SEBlock(hidden, _make_divisible(hidden * se_ratio), act="relu", gate="hardsigmoid") if se_ratio else None
        layers = []
        if expanded:
            layers += [*_conv_bn(in_channels, hidden, 1), get_activation(act)]
        layers += _conv_bn(hidden, hidden, kernel, stride, groups=hidden)
        if se_before_act and expanded:
            layers += [se or nn.Identity(), get_activation(act)]
        else:
            layers.append(get_activation(act))
            if se_before_act:  # V3's block without expansion: [dw, bn, act, SE, pwl, bn]
                layers.append(se or nn.Identity())
            elif se is not None:
                layers.append(se)
        layers += _conv_bn(hidden, out_channels, 1)
        self.conv = nn.Sequential(*layers)
        self._tap_index = 2 if expanded else None

    def forward(self, x: torch.Tensor):
        if self.tap_expand:
            expanded = self.conv[: self._tap_index + 1](x)
            y = self.conv[self._tap_index + 1:](expanded)
        else:
            y = self.conv(x)
        if self.use_residual:
            y = y + x
        return (y, expanded) if self.tap_expand else y


@torch.no_grad()
def reset_mobilenet_parameters(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init: He-normal conv weights, LeCun-normal ``Linear`` weights, zero
    biases, unit BN affine and (0, 1) running stats."""
    for module in net.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            gain = 2.0 if isinstance(module, nn.Conv2d) else 1.0
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * math.sqrt(gain / fan_in))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
    return net


# (expand, channels, repeats, stride)
MOBILENET_V2_CFG: Tuple = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                           (6, 320, 1, 1))


def mobilenet_v2_blocks(in_channels: int, width_mult: float = 1.0, tap_block: Optional[int] = None):
    """V2's 17 inverted-residual blocks after a stem of ``in_channels``; ``tap_block`` marks
    the block whose expanded features are tapped. Returns ``(blocks, out_channels)``."""
    blocks, cin, i = [], in_channels, 0
    for t, c, n, s in MOBILENET_V2_CFG:
        cc = _make_divisible(c * width_mult)
        for j in range(n):
            blocks.append(InvertedResidual(cin, cc, s if j == 0 else 1, t, tap_expand=i == tap_block))
            cin, i = cc, i + 1
    return blocks, cin


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0, dropout: float = 0.2):
        super().__init__()
        c0 = _make_divisible(32 * width_mult)
        blocks, cin = mobilenet_v2_blocks(c0, width_mult)
        last = _make_divisible(1280 * max(1.0, width_mult))
        self.features = nn.Sequential(conv_bn_act(3, c0, 3, 2, "relu6"), *blocks, conv_bn_act(cin, last, 1, 1, "relu6"))
        self.classifier = nn.Sequential(SeededDropout(dropout), nn.Linear(last, num_classes))

    def reset_parameters(self, generator: torch.Generator) -> "MobileNetV2":
        return reset_mobilenet_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.features(x).mean(dim=(2, 3)))


# (kernel, expand_ch, out_ch, se, act, stride)
MOBILENET_V3_LARGE: Tuple = (
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
)
MOBILENET_V3_SMALL: Tuple = (
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
)


class MobileNetV3(nn.Module):
    def __init__(self, num_classes: int = 1000, mode: str = "large", width_mult: float = 1.0, dropout: float = 0.2):
        super().__init__()
        cfg = MOBILENET_V3_LARGE if mode == "large" else MOBILENET_V3_SMALL
        cin = _make_divisible(16 * width_mult)
        layers = [conv_bn_act(3, cin, 3, 2, "hardswish")]
        for k, exp, c, se, act, s in cfg:
            cc = _make_divisible(c * width_mult)
            layers.append(InvertedResidual(cin, cc, s, _make_divisible(exp * width_mult) / cin, kernel=k, act=act,
                                           se_ratio=0.25 if se else None, se_before_act=True))
            cin = cc
        self.features = nn.Sequential(*layers)
        last_exp = _make_divisible((960 if mode == "large" else 576) * width_mult)
        self.conv = conv_bn_act(cin, last_exp, 1, 1, "hardswish")
        head_dim = 1280 if mode == "large" else 1024
        self.classifier = nn.Sequential(nn.Linear(last_exp, head_dim), nn.Hardswish(), SeededDropout(dropout),
                                        nn.Linear(head_dim, num_classes))

    def reset_parameters(self, generator: torch.Generator) -> "MobileNetV3":
        return reset_mobilenet_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.conv(self.features(x)).mean(dim=(2, 3)))


class MobileNetV1Block(nn.Module):
    """The depthwise 3x3 ``conv1`` / ``bn1`` and the pointwise ``conv2`` / ``bn2``, each
    followed by a ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, in_channels, 3, stride, 1, groups=in_channels, bias=False)
        self.bn1 = nn.BatchNorm2d(in_channels)
        self.conv2 = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x))))))


MOBILENET_V1_CFG: Tuple = (64, 128, (128, 2), 256, (256, 2), 512, 512, 512, 512, 512, (512, 2), 1024, (1024, 2))


class MobileNetV1(nn.Module):
    """MobileNetV1 over the blocks of ``cfg`` (``backbone_mode`` returns the last block's
    map and builds no ``linear``)."""

    def __init__(self, num_classes: int = 1000, backbone_mode: bool = False, cfg: Sequence = MOBILENET_V1_CFG,
                 input_hw: Tuple[int, int] = (64, 64)):
        super().__init__()
        self.backbone_mode = backbone_mode
        self.conv1 = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        blocks, cin, stride = [], 32, 2
        for c in cfg:
            out, s = (c, 1) if isinstance(c, int) else c
            blocks.append(MobileNetV1Block(cin, out, s))
            cin, stride = out, stride * s
        self.layers = nn.Sequential(*blocks)
        if not backbone_mode:
            h, w = (-(-side // stride) // 2 for side in input_hw)  # the map after the 2x2 average pool
            self.linear = nn.Linear(cin * h * w, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> "MobileNetV1":
        return reset_mobilenet_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layers(F.relu(self.bn1(self.conv1(x))))
        if self.backbone_mode:
            return x
        return self.linear(F.avg_pool2d(x, 2).flatten(1))
