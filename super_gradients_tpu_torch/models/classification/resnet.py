"""ResNet family, NCHW (counterpart of ``super_gradients_tpu/models/classification/resnet.py``).

Attribute names are the original super-gradients ones (``conv1`` / ``bn1`` stem,
``layer1``..``layer4`` of blocks with ``conv{1,2,3}`` / ``bn{1,2,3}`` and a ``shortcut``
``Sequential(conv, bn)``, ``linear`` head), so ``conversion/from_jax.py::RESNET_RULES``
carries the JAX parameters across one to one.

As in the JAX modules: a block's BatchNorms use momentum ``bn_momentum`` in torch's
convention (flax ``1 - bn_momentum``), the stem's BN torch's 0.1 (flax 0.9); the
ImageNet stem's max pool pads with ``-inf`` (``F.max_pool2d(3, 2, padding=1)``); the
head is a global mean over H and W, then ``linear``; a shortcut exists only when the
stride is not 1 or the channel count changes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.modules.blocks import width_multiplier


class BasicResNetBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1, expansion: int = 1, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, final_relu: bool = True):
        super().__init__()
        self.final_relu = final_relu
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=bn_eps, momentum=bn_momentum)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=bn_eps, momentum=bn_momentum)
        self.shortcut = _shortcut(in_planes, planes * expansion, stride, bn_eps, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out)) + self.shortcut(x)
        return F.relu(out) if self.final_relu else out


class BottleneckBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1, expansion: int = 4, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, final_relu: bool = True):
        super().__init__()
        self.final_relu = final_relu
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=bn_eps, momentum=bn_momentum)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=bn_eps, momentum=bn_momentum)
        self.conv3 = nn.Conv2d(planes, planes * expansion, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * expansion, eps=bn_eps, momentum=bn_momentum)
        self.shortcut = _shortcut(in_planes, planes * expansion, stride, bn_eps, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out)) + self.shortcut(x)
        return F.relu(out) if self.final_relu else out


def _shortcut(in_planes: int, out_planes: int, stride: int, bn_eps: float, bn_momentum: float) -> nn.Sequential:
    """The projection ``Sequential(conv 1x1, bn)`` where the stride or the width changes, else
    an empty ``Sequential`` (the identity, with no parameters)."""
    if stride == 1 and in_planes == out_planes:
        return nn.Sequential()
    return nn.Sequential(nn.Conv2d(in_planes, out_planes, 1, stride, bias=False),
                         nn.BatchNorm2d(out_planes, eps=bn_eps, momentum=bn_momentum))


def _make_layers(module: nn.Module, in_planes: int, num_blocks: Sequence[int], block: str, width_mult: float,
                 expansion: int) -> int:
    """``layer1``..``layer4`` on ``module``; returns the channels they end with."""
    block_cls = BasicResNetBlock if block == "basic" else BottleneckBlock
    for i, (planes, n, stride) in enumerate(zip((64, 128, 256, 512), num_blocks, (1, 2, 2, 2))):
        planes = width_multiplier(planes, width_mult)
        blocks = []
        for b in range(n):
            blocks.append(block_cls(in_planes, planes, stride=stride if b == 0 else 1, expansion=expansion))
            in_planes = planes * expansion
        setattr(module, f"layer{i + 1}", nn.Sequential(*blocks))
    return in_planes


class _ResNetBase(nn.Module):
    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "_ResNetBase":
        """Seeded random init: He-normal conv weights, LeCun-normal ``linear`` weights and
        zero bias (flax's ``Dense`` default), unit BN affine and (0, 1) running stats."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                fan_in = module.weight[0].numel()
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in))
            elif isinstance(module, nn.Linear):
                fan_in = module.weight.shape[1]
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * math.sqrt(1.0 / fan_in))
                module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
        return self

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x.mean(dim=(2, 3))  # global average pool


class ResNet(_ResNetBase):
    """ImageNet-style ResNet: 7x7 stride-2 stem and a 3x3 stride-2 max pool.
    ``backbone_mode`` returns the pooled features and builds no ``linear``."""

    def __init__(self, num_blocks: Sequence[int], num_classes: int = 1000, block: str = "basic",
                 width_mult: float = 1.0, expansion: Optional[int] = None, backbone_mode: bool = False):
        super().__init__()
        exp = expansion if expansion is not None else (1 if block == "basic" else 4)
        self.backbone_mode = backbone_mode
        stem = width_multiplier(64, width_mult)
        self.conv1 = nn.Conv2d(3, stem, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(stem, momentum=0.1)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)  # pads with -inf, as the JAX stem does
        out_channels = _make_layers(self, stem, num_blocks, block, width_mult, exp)
        if not backbone_mode:
            self.linear = nn.Linear(out_channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        x = self._features(x)
        return x if self.backbone_mode else self.linear(x)


class CifarResNet(_ResNetBase):
    """CIFAR-style ResNet: 3x3 stride-1 stem, no max pool."""

    def __init__(self, num_blocks: Sequence[int], num_classes: int = 10, block: str = "basic",
                 width_mult: float = 1.0):
        super().__init__()
        exp = 1 if block == "basic" else 4
        stem = width_multiplier(64, width_mult)
        self.conv1 = nn.Conv2d(3, stem, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(stem, momentum=0.1)
        out_channels = _make_layers(self, stem, num_blocks, block, width_mult, exp)
        self.linear = nn.Linear(out_channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self._features(F.relu(self.bn1(self.conv1(x)))))
