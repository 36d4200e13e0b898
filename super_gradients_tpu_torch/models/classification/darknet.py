"""Darknet-53 and CSPDarknet-53 classifiers, NCHW (counterpart of
``super_gradients_tpu/models/classification/darknet.py``).

Attribute names are the original super-gradients ones, which ``conversion/from_jax.py``'s
``DARKNET53_RULES`` and ``CSP_DARKNET53_RULES`` reach:

- Darknet-53: one flat ``modules_list``: the stem at 0, the stride-2 convs at the odd slots, the
  stages of residual blocks (``layer1`` 1x1 to half the width, ``layer2`` 3x3 back) at the even
  ones, the head ``11.fc``; each conv-BN's layers are named ``Conv2d`` and ``BatchNorm2d``, with
  LeakyReLU at torch's default slope 0.01.
- CSPDarknet-53: as in the JAX package, the classifier sits on the port's YOLOX ``CSPDarknet``
  trunk (6x6 stride-2 stem, SiLU) whose ``_modules_list`` it takes over at slots 0-9, the
  ``Linear`` head at slot 12, on the mean of the trunk's last map. The original's CSPDarknet-53
  is not the YOLOX trunk (ROADMAP.md section 3).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.classification.common import ClassifierNet, global_mean
from super_gradients_tpu_torch.models.detection.yolox import CSPDarknet


class DarkConv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.Conv2d = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.BatchNorm2d = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.BatchNorm2d(self.Conv2d(x)), 0.01)


class DarkResidualBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.layer1 = DarkConv(channels, channels // 2, 1)
        self.layer2 = DarkConv(channels // 2, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer2(self.layer1(x))


class DarkHead(nn.Module):
    def __init__(self, channels: int, num_classes: int):
        super().__init__()
        self.fc = nn.Linear(channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(global_mean(x))


class Darknet53(ClassifierNet):
    def __init__(self, num_classes: int = 1000, blocks: Sequence[int] = (1, 2, 8, 8, 4)):
        super().__init__()
        layers, cin, ch = [DarkConv(3, 32, 3)], 32, 64
        for n in blocks:
            layers.append(DarkConv(cin, ch, 3, 2))
            layers.append(nn.Sequential(*(DarkResidualBlock(ch) for _ in range(n))))
            cin, ch = ch, min(ch * 2, 1024)
        layers.append(DarkHead(cin, num_classes))
        self.modules_list = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.modules_list:
            x = layer(x)
        return x


class CSPDarknet53(ClassifierNet):
    def __init__(self, num_classes: int = 1000, depth_mult: float = 1.0, width_mult: float = 1.0):
        super().__init__()
        trunk = CSPDarknet(width=width_mult, depth=depth_mult)
        head = nn.Linear(trunk._modules_list[9].conv3.conv.out_channels, num_classes)
        self._modules_list = nn.ModuleList([*trunk._modules_list, nn.Identity(), nn.Identity(), head])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self._modules_list
        for i in range(10):
            x = m[i](x)
        return m[12](global_mean(x))
