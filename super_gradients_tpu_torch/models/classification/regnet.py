"""RegNetY, NCHW (counterpart of ``super_gradients_tpu/models/classification/regnet.py``).

Attribute names are the original super-gradients ones: everything under ``net``, the stem
``net.stem.{conv, bn}``, the blocks ``net.stage_{i}.blocks.block_{j}`` with ``conv_block_1`` /
``conv_block_2`` / ``conv_block_3`` Sequentials (conv, bn[, relu]), the squeeze-excitation
``se`` Sequential (pool, conv, relu, conv, sigmoid) and the ``shortcut`` Sequential (conv, bn),
the head ``net.head.fc``; ``conversion/from_jax.py``'s ``REGNET_RULES`` carry the JAX variables
across.

As in the JAX modules: the stage widths and depths come from :func:`generate_widths`, number
for number; the first block of every stage has stride 2; the grouped 3x3 conv has
``out // group_width`` groups; the squeeze-excitation squeezes to ``int(cin * se_ratio)`` of
the block input; a shortcut projection where the stride or the width changes; BN eps 1e-5,
momentum 0.1.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.classification.common import ClassifierNet, global_mean

# variant: (initial_width, slope, quantized_param, depth, group_width, se_ratio), the original's
# constants
REGNETY_PARAMS: Dict[str, Tuple] = {
    "regnetY200": (24, 36, 2.5, 13, 8, 0.25),
    "regnetY400": (48, 28, 2.1, 16, 8, 0.25),
    "regnetY600": (48, 33, 2.3, 15, 16, 0.25),
    "regnetY800": (56, 39, 2.4, 14, 16, 0.25),
}


def generate_widths(initial_width: float, slope: float, q: float, depth: int, group_width: int
                    ) -> Tuple[List[int], List[int]]:
    """Per-stage (widths, depths): the quantized log ladder on multiples of 8, grouped into
    stages by ``np.unique``, each width rounded to its group width."""
    pw = initial_width + slope * np.arange(depth)
    pb = np.round(np.log(pw / initial_width) / np.log(q))
    qw = 8 * np.round(initial_width * np.power(q, pb) / 8)
    stage_widths, stage_depths = np.unique(qw.astype(np.int64), return_counts=True)
    gw = np.minimum(group_width, stage_widths)
    stage_widths = (np.round(stage_widths / gw) * gw).astype(np.int64)
    return stage_widths.tolist(), stage_depths.tolist()


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1, relu: bool = True) -> nn.Sequential:
    layers = [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False), nn.BatchNorm2d(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class YBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int, group_width: int, se_ratio: float):
        super().__init__()
        squeeze = max(1, int(in_channels * se_ratio))
        self.conv_block_1 = _conv_bn(in_channels, out_channels, 1)
        self.conv_block_2 = _conv_bn(out_channels, out_channels, 3, stride, groups=max(1, out_channels // group_width))
        self.se = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(out_channels, squeeze, 1), nn.ReLU(),
                                nn.Conv2d(squeeze, out_channels, 1), nn.Sigmoid())
        self.conv_block_3 = _conv_bn(out_channels, out_channels, 1, relu=False)
        self.shortcut = (_conv_bn(in_channels, out_channels, 1, stride, relu=False)
                         if stride != 1 or in_channels != out_channels else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_block_2(self.conv_block_1(x))
        y = self.conv_block_3(y * self.se(y))
        return F.relu(y + self.shortcut(x))


class Stage(nn.Module):
    def __init__(self, blocks: List[YBlock]):
        super().__init__()
        self.blocks = nn.Sequential(OrderedDict((f"block_{j}", b) for j, b in enumerate(blocks)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x)


class RegNetY(ClassifierNet):
    def __init__(self, num_classes: int = 1000, initial_width: float = 24, slope: float = 36.44,
                 quantized_param: float = 2.49, depth: int = 13, group_width: int = 8, se_ratio: float = 0.25):
        super().__init__()
        self.net = nn.Module()
        self.net.stem = nn.Sequential(OrderedDict(conv=nn.Conv2d(3, 32, 3, 2, 1, bias=False), bn=nn.BatchNorm2d(32),
                                                  act=nn.ReLU()))
        cin = 32
        widths, depths = generate_widths(initial_width, slope, quantized_param, depth, group_width)
        self.num_stages = len(widths)
        for si, (w, d) in enumerate(zip(widths, depths)):
            blocks = []
            for bi in range(d):
                blocks.append(YBlock(cin, w, 2 if bi == 0 else 1, group_width, se_ratio))
                cin = w
            setattr(self.net, f"stage_{si}", Stage(blocks))
        self.net.head = nn.Module()
        self.net.head.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.net.stem(x)
        for si in range(self.num_stages):
            x = getattr(self.net, f"stage_{si}")(x)
        return self.net.head.fc(global_mean(x))
