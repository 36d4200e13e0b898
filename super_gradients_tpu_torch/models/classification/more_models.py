"""PreActResNet-18, GoogLeNet and SENet-18, NCHW (counterpart of
``super_gradients_tpu/models/classification/more_models.py``).

Attribute names are the original super-gradients ones, which ``conversion/from_jax.py``'s
``PREACT_RULES`` and ``SENET_RULES`` reach, and the generic rules for GoogLeNet:

- PreActResNet: ``conv1``, ``layer{1..4}.{j}`` with ``bn1``, ``conv1``, ``bn2``, ``conv2`` and the
  ``shortcut`` Sequential (one conv, fed ``relu(bn1(x))``), ``linear``; no BN or ReLU after the last
  stage.
- GoogLeNet (torchvision layout, no aux heads): ``conv1``..``conv3`` and the inceptions'
  ``branch1``, ``branch2.{0,1}``, ``branch3.{0,1}``, ``branch4.1`` (after the max pool), each a conv
  and ``bn`` (eps 1e-3) then ReLU; the max pools between stages take torch's ``ceil_mode`` windows,
  padded on the right and bottom with ``-inf`` as the JAX ``_ceil_maxpool`` does; dropout
  (:class:`SeededDropout`) before ``fc``.
- SENet-18 (the CIFAR form): the stem ``conv1`` / ``bn1``, pre-activation blocks ``layer{1..4}.{j}``
  (``bn1``, ``conv1``, ``bn2``, ``conv2``, the squeeze-excitation ``fc1`` / ``fc2`` 1x1 convs with
  bias, a BN-less ``shortcut`` Sequential fed ``relu(bn1(x))``), ``linear``.

As in the JAX modules, the BNs the JAX module builds with flax's defaults (PreAct's and SENet's
blocks) take momentum 0.01 in torch's convention, the ``ConvBNAct`` ones 0.1.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.classification.common import ClassifierNet, global_mean
from super_gradients_tpu_torch.models.segmentation.stdc import SeededDropout
from super_gradients_tpu_torch.modules.blocks import ConvBNAct

FLAX_BN_MOMENTUM = 0.01  # flax's BatchNorm default 0.99, in torch's convention


class PreActBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_planes, momentum=FLAX_BN_MOMENTUM)
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, momentum=FLAX_BN_MOMENTUM)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.project = stride != 1 or in_planes != planes
        if self.project:
            self.shortcut = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(x))
        shortcut = self.shortcut(out) if self.project else x
        out = self.conv1(out)
        return self.conv2(F.relu(self.bn2(out))) + shortcut


def _stages(module: nn.Module, block_cls, num_blocks: Sequence[int]) -> int:
    cin = 64
    for si, (planes, n) in enumerate(zip((64, 128, 256, 512), num_blocks)):
        blocks = []
        for bi in range(n):
            blocks.append(block_cls(cin, planes, 2 if (bi == 0 and si > 0) else 1))
            cin = planes
        setattr(module, f"layer{si + 1}", nn.Sequential(*blocks))
    return cin


class PreActResNet(ClassifierNet):
    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2), num_classes: int = 10):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.linear = nn.Linear(_stages(self, PreActBlock, num_blocks), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        for si in range(1, 5):
            x = getattr(self, f"layer{si}")(x)
        return self.linear(global_mean(x))


def ceil_max_pool(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """torch's ``MaxPool2d(k, s, ceil_mode=True)`` as the JAX ``_ceil_maxpool`` writes it: the
    overhang padded with ``-inf`` on the right and bottom only."""
    h, w = x.shape[-2:]
    pad_h = max(0, (math.ceil((h - k) / s) + 1 - 1) * s + k - h)
    pad_w = max(0, (math.ceil((w - k) / s) + 1 - 1) * s + k - w)
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> ConvBNAct:
    return ConvBNAct(cin, cout, kernel, stride, bn_eps=1e-3)


class Inception(nn.Module):
    def __init__(self, cin: int, n1x1: int, n3x3red: int, n3x3: int, n5x5red: int, n5x5: int, pool_planes: int):
        super().__init__()
        self.out_channels = n1x1 + n3x3 + n5x5 + pool_planes
        self.branch1 = _conv(cin, n1x1, 1)
        self.branch2 = nn.Sequential(_conv(cin, n3x3red, 1), _conv(n3x3red, n3x3, 3))
        self.branch3 = nn.Sequential(_conv(cin, n5x5red, 1), _conv(n5x5red, n5x5, 3))
        self.branch4 = nn.Sequential(nn.MaxPool2d(3, 1, padding=1), _conv(cin, pool_planes, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x), self.branch4(x)], dim=1)


# name: (n1x1, n3x3red, n3x3, n5x5red, n5x5, pool_planes)
INCEPTIONS = (("inception3a", (64, 96, 128, 16, 32, 32)), ("inception3b", (128, 128, 192, 32, 96, 64)),
              ("inception4a", (192, 96, 208, 16, 48, 64)), ("inception4b", (160, 112, 224, 24, 64, 64)),
              ("inception4c", (128, 128, 256, 24, 64, 64)), ("inception4d", (112, 144, 288, 32, 64, 64)),
              ("inception4e", (256, 160, 320, 32, 128, 128)), ("inception5a", (256, 160, 320, 32, 128, 128)),
              ("inception5b", (384, 192, 384, 48, 128, 128)))
POOL_BEFORE = {"inception3a": (3, 2), "inception4a": (3, 2), "inception5a": (2, 2)}  # ceil-mode max pools


class GoogLeNet(ClassifierNet):
    def __init__(self, num_classes: int = 1000, dropout: float = 0.2):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.conv2 = _conv(64, 64, 1)
        self.conv3 = _conv(64, 192, 3)
        cin = 192
        for name, widths in INCEPTIONS:
            block = Inception(cin, *widths)
            setattr(self, name, block)
            cin = block.out_channels
        self.dropout = SeededDropout(dropout)
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ceil_max_pool(self.conv1(x), 3, 2)
        x = self.conv3(self.conv2(x))
        for name, _ in INCEPTIONS:
            if name in POOL_BEFORE:
                x = ceil_max_pool(x, *POOL_BEFORE[name])
            x = getattr(self, name)(x)
        return self.fc(self.dropout(global_mean(x)))


class SEBasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_planes, momentum=FLAX_BN_MOMENTUM)
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, momentum=FLAX_BN_MOMENTUM)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.fc1 = nn.Conv2d(planes, planes // 16, 1)
        self.fc2 = nn.Conv2d(planes // 16, planes, 1)
        self.project = stride != 1 or in_planes != planes
        if self.project:
            self.shortcut = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(x))
        shortcut = self.shortcut(out) if self.project else x
        out = self.conv2(F.relu(self.bn2(self.conv1(out))))
        w = torch.sigmoid(self.fc2(F.relu(self.fc1(out.mean(dim=(2, 3), keepdim=True)))))
        return out * w + shortcut


class SENetCifar(ClassifierNet):
    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2), num_classes: int = 10):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.linear = nn.Linear(_stages(self, SEBasicBlock, num_blocks), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        for si in range(1, 5):
            x = getattr(self, f"layer{si}")(x)
        return self.linear(global_mean(x))
