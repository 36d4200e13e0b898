"""VGG, LeNet, ShuffleNetV2, DenseNet and ResNeXt, NCHW (counterpart of
``super_gradients_tpu/models/classification/misc_models.py``).

Attribute names are the original super-gradients ones, which ``conversion/from_jax.py``'s
``vgg_rules``, ``SHUFFLENET_RULES``, ``DENSENET_RULES`` and ``RESNEXT_RULES`` reach:

- VGG (the CIFAR form): ``features`` one flat Sequential, three entries a conv (conv with bias,
  BN, ReLU) and one a max pool; ``classifier`` on the global mean.
- LeNet: ``conv1``, ``conv2`` (5x5, unpadded, with bias), ``fc1``..``fc3``. The features are
  flattened in the JAX module's NHWC order (height, width, channel): ``fc1`` is JAX's.
- ShuffleNetV2: ``conv1`` (conv, BN, ReLU), a ``-inf``-padded 3x3 stride-2 max pool, the stages
  ``layer2``..``layer4`` of blocks with ``branch1`` (stride 2: depthwise conv, BN, conv, BN, ReLU)
  and ``branch2`` (conv, BN, ReLU, depthwise conv, BN, conv, BN, ReLU), ``conv5``, ``fc``. A stride-1
  block splits its input with ``chunk(2, dim=1)`` and feeds the second half to ``branch2``; the
  channel shuffle is ``view(B, 2, C / 2, H, W).transpose(1, 2)``.
- DenseNet: the torchvision tree under ``features`` (``conv0``, ``norm0``, ``denseblock{b}.
  denselayer{l}.{norm1, conv1, norm2, conv2}``, ``transition{b}.{norm, conv}``, ``norm5``) and
  ``classifier``.
- ResNeXt: the torchvision layout (``conv1`` / ``bn1``, ``layer{1..4}.{j}`` with ``conv{1,2,3}`` /
  ``bn{1,2,3}`` and a ``downsample`` Sequential, ``fc``).

As in the JAX modules, the BNs the JAX module builds with flax's defaults (DenseNet's) take
momentum 0.01 in torch's convention, the ``ConvBNAct`` ones 0.1.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.classification.common import ClassifierNet, global_mean

FLAX_BN_MOMENTUM = 0.01  # flax's BatchNorm default 0.99, in torch's convention

VGG_CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(ClassifierNet):
    def __init__(self, cfg: Tuple, num_classes: int = 10):
        super().__init__()
        layers, cin = [], 3
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, int(v), 3, 1, 1), nn.BatchNorm2d(int(v)), nn.ReLU()]
                cin = int(v)
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(global_mean(self.features(x)))


class LeNet(ClassifierNet):
    """The 32x32 LeNet."""

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 6, 5)
        self.conv2 = nn.Conv2d(6, 16, 5)
        self.fc1 = nn.Linear(16 * 5 * 5, 120)
        self.fc2 = nn.Linear(120, 84)
        self.fc3 = nn.Linear(84, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # the JAX module's NHWC order (ROADMAP.md section 3)
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1):
    return [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False), nn.BatchNorm2d(cout)]


def channel_shuffle(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.view(b, 2, c // 2, h, w).transpose(1, 2).reshape(b, c, h, w)


class ShuffleV2Block(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.stride = stride
        half = out_channels // 2
        if stride == 1:
            branch_in = in_channels // 2
        else:
            branch_in = in_channels
            self.branch1 = nn.Sequential(*_conv_bn(in_channels, in_channels, 3, 2, groups=in_channels),
                                         *_conv_bn(in_channels, half, 1), nn.ReLU())
        self.branch2 = nn.Sequential(*_conv_bn(branch_in, half, 1), nn.ReLU(),
                                     *_conv_bn(half, half, 3, stride, groups=half),
                                     *_conv_bn(half, half, 1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out)


class ShuffleNetV2(ClassifierNet):
    def __init__(self, num_classes: int = 1000, stage_channels: Sequence[int] = (116, 232, 464),
                 stage_repeats: Sequence[int] = (4, 8, 4)):
        super().__init__()
        self.conv1 = nn.Sequential(*_conv_bn(3, 24, 3, 2), nn.ReLU())
        cin = 24
        for si, (c, n) in enumerate(zip(stage_channels, stage_repeats)):
            blocks = []
            for bi in range(n):
                blocks.append(ShuffleV2Block(cin, c, 2 if bi == 0 else 1))
                cin = c
            setattr(self, f"layer{si + 2}", nn.Sequential(*blocks))
        self.num_stages = len(stage_channels)
        self.conv5 = nn.Sequential(*_conv_bn(cin, 1024, 1), nn.ReLU())
        self.fc = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(self.conv1(x), 3, 2, padding=1)  # pads with -inf, as the JAX stem
        for si in range(self.num_stages):
            x = getattr(self, f"layer{si + 2}")(x)
        return self.fc(global_mean(self.conv5(x)))


def _flax_bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, momentum=FLAX_BN_MOMENTUM)


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = _flax_bn(in_channels)
        self.conv1 = nn.Conv2d(in_channels, bn_size * growth_rate, 1, bias=False)
        self.norm2 = _flax_bn(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        return torch.cat([x, self.conv2(F.relu(self.norm2(y)))], dim=1)


class Transition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm = _flax_bn(in_channels)
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(ClassifierNet):
    def __init__(self, num_classes: int = 1000, growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 24, 16),
                 init_features: int = 64):
        super().__init__()
        self.features = nn.Module()
        self.features.conv0 = nn.Conv2d(3, init_features, 7, 2, 3, bias=False)
        self.features.norm0 = _flax_bn(init_features)
        self.num_blocks = len(block_config)
        c = init_features
        for bi, n in enumerate(block_config):
            block = nn.Module()
            for li in range(n):
                setattr(block, f"denselayer{li + 1}", DenseLayer(c, growth_rate))
                c += growth_rate
            setattr(self.features, f"denseblock{bi + 1}", block)
            if bi != len(block_config) - 1:
                setattr(self.features, f"transition{bi + 1}", Transition(c, c // 2))
                c //= 2
        self.features.norm5 = _flax_bn(c)
        self.classifier = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features
        x = F.relu(f.norm0(f.conv0(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf, as the JAX stem
        for bi in range(1, self.num_blocks + 1):
            for layer in getattr(f, f"denseblock{bi}").children():
                x = layer(x)
            if bi != self.num_blocks:
                x = getattr(f, f"transition{bi}")(x)
        return self.classifier(global_mean(F.relu(f.norm5(x))))


class ResNeXtBlock(nn.Module):
    """The grouped bottleneck: width ``planes * base_width * cardinality / 64``, output ``planes * 4``."""

    def __init__(self, in_channels: int, planes: int, cardinality: int = 32, base_width: int = 4, stride: int = 1):
        super().__init__()
        width = planes * base_width * cardinality // 64
        out = planes * 4
        self.conv1 = nn.Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=cardinality, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(*_conv_bn(in_channels, out, 1, stride))
                           if stride != 1 or in_channels != out else nn.Sequential())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + self.downsample(x))


class ResNeXt(ClassifierNet):
    """ResNeXt 32x4d."""

    def __init__(self, num_classes: int = 1000, num_blocks: Sequence[int] = (3, 4, 6, 3), cardinality: int = 32,
                 base_width: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin, planes = 64, 64
        for si, n in enumerate(num_blocks):
            blocks = []
            for bi in range(n):
                blocks.append(ResNeXtBlock(cin, planes, cardinality, base_width, 2 if (bi == 0 and si > 0) else 1))
                cin = planes * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)  # pads with -inf, as the JAX stem
        for si in range(1, 5):
            x = getattr(self, f"layer{si}")(x)
        return self.fc(global_mean(x))
