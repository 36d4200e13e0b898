"""EfficientNet B0-B8 and L2, NCHW (counterpart of
``super_gradients_tpu/models/classification/efficientnet.py``).

Attribute names are the original super-gradients ones (``_conv_stem`` / ``_bn0``, ``_blocks.{i}``
with ``_expand_conv`` / ``_bn0``, ``_depthwise_conv`` / ``_bn1``, ``_se_reduce`` / ``_se_expand``,
``_project_conv`` / ``_bn2``, then ``_conv_head`` / ``_bn1`` and ``_fc``), so that
``conversion/from_jax.py``'s ``EFFICIENTNET_RULES`` carry the JAX variables across and an original
checkpoint loads.

As in the JAX modules: every conv pads as XLA's ``SAME`` (asymmetric at stride 2: ``(0, 1)`` on the
stem at 224); every BN has eps 1e-3 and momentum 0.01 (torch's convention); SiLU throughout; the
squeeze-excitation of a block squeezes to ``cin // 4`` of the block input (at least 1), SiLU, then a
sigmoid gate, in every block; the residual where the stride is 1 and the width is kept; dropout
(:class:`SeededDropout`) on the pooled features before ``_fc``. Widths and depths follow the
compound scaling (``_round_filters``, ``_round_repeats``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.classification.common import ClassifierNet, SameConv2d, global_mean
from super_gradients_tpu_torch.models.segmentation.stdc import SeededDropout

# (expand, channels, repeats, stride, kernel)
BASE_CFG: Tuple = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3), (6, 112, 3, 1, 5),
                   (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))

# variant: (width_coeff, depth_coeff, resolution, dropout)
EFFICIENTNET_PARAMS: Dict[str, Tuple[float, float, int, float]] = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
    "b8": (2.2, 3.6, 672, 0.5),
    "l2": (4.3, 5.3, 800, 0.5),
}
BN_EPS, BN_MOMENTUM = 1e-3, 0.01


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class MBConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int, expand_ratio: int, kernel: int):
        super().__init__()
        hidden = in_channels * expand_ratio
        self.expand = expand_ratio != 1
        if self.expand:
            self._expand_conv = SameConv2d(in_channels, hidden, 1, bias=False)
            self._bn0 = _bn(hidden)
        self._depthwise_conv = SameConv2d(hidden, hidden, kernel, stride, groups=hidden, bias=False)
        self._bn1 = _bn(hidden)
        squeeze = max(1, in_channels // 4)
        self._se_reduce = nn.Conv2d(hidden, squeeze, 1)
        self._se_expand = nn.Conv2d(squeeze, hidden, 1)
        self._project_conv = SameConv2d(hidden, out_channels, 1, bias=False)
        self._bn2 = _bn(out_channels)
        self.use_residual = stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self._bn0(self._expand_conv(x))) if self.expand else x
        y = F.silu(self._bn1(self._depthwise_conv(y)))
        y = y * torch.sigmoid(self._se_expand(F.silu(self._se_reduce(y.mean(dim=(2, 3), keepdim=True)))))
        y = self._bn2(self._project_conv(y))
        return y + x if self.use_residual else y


class EfficientNet(ClassifierNet):
    def __init__(self, num_classes: int = 1000, width_coeff: float = 1.0, depth_coeff: float = 1.0,
                 dropout: float = 0.2):
        super().__init__()
        stem = round_filters(32, width_coeff)
        self._conv_stem = SameConv2d(3, stem, 3, 2, bias=False)
        self._bn0 = _bn(stem)
        blocks, cin = [], stem
        for expand, c, n, s, k in BASE_CFG:
            cout = round_filters(c, width_coeff)
            for j in range(round_repeats(n, depth_coeff)):
                blocks.append(MBConvBlock(cin, cout, s if j == 0 else 1, expand, k))
                cin = cout
        self._blocks = nn.ModuleList(blocks)
        head = round_filters(1280, width_coeff)
        self._conv_head = SameConv2d(cin, head, 1, bias=False)
        self._bn1 = _bn(head)
        self._dropout = SeededDropout(dropout)
        self._fc = nn.Linear(head, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self._bn0(self._conv_stem(x)))
        for block in self._blocks:
            x = block(x)
        x = global_mean(F.silu(self._bn1(self._conv_head(x))))
        return self._fc(self._dropout(x))
