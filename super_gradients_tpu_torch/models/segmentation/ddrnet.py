"""DDRNet 23 / 23-slim / 39, segmentation mode, NCHW (counterpart of
``super_gradients_tpu/models/segmentation/ddrnet.py``).

Attribute names are the original super-gradients ones, so that
``conversion/from_jax.py::DDRNET_RULES`` carries the JAX parameters across: the stem and
``layer1``-``layer4`` of the low-resolution trunk under ``_backbone`` (``layer3`` a
``ModuleList`` of its repeats), the high-resolution branch ``layer3_skip`` (a ``ModuleList``),
``layer4_skip``, ``layer5_skip``, ``layer5``, the bilateral fusions ``down3`` /
``compression3`` (``ModuleList``s), ``down4`` / ``compression4``, each ``ConvBN`` a
``Sequential(conv, bn[, relu])``, the DAPPM context ``spp`` and the heads ``final_layer`` /
``seghead_extra``.

As in the JAX modules: every BN has torch momentum 0.1 (flax 0.9); a layer's last block has
no final ReLU; a DAPPM branch of stride ``s > 1`` average-pools with kernel ``k`` over ``s``
pixels of zero padding that count, and stride 0 is the global mean; every resize upsamples
with the half-pixel bilinear grid (``jax.image.resize``), to ``H // 8 x W // 8`` inside the
network and by 8 in the heads. With ``use_aux_heads`` the train-mode output is
``(main, aux)``; eval mode returns ``main`` alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.classification.resnet import BasicResNetBlock, BottleneckBlock
from super_gradients_tpu_torch.models.segmentation.stdc import reset_segmentation_parameters, resize_to


def conv_bn(cin: int, cout: int, kernel: int = 3, stride: int = 1, add_relu: bool = False,
            bias: bool = False) -> nn.Sequential:
    """The original ``ConvBN``: ``Sequential(conv, bn[, relu])``."""
    layers = [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=bias), nn.BatchNorm2d(cout, momentum=0.1)]
    if add_relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def make_layer(block: str, cin: int, planes: int, num_blocks: int, stride: int, expansion: int) -> nn.Sequential:
    """``num_blocks`` residual blocks, the first with ``stride``; the last one without its final
    ReLU (every block keeps it where there is only one)."""
    cls = BasicResNetBlock if block == "basic" else BottleneckBlock
    blocks = []
    for i in range(num_blocks):
        blocks.append(cls(cin, planes, stride=stride if i == 0 else 1, expansion=expansion,
                          final_relu=num_blocks > 1 and i < num_blocks - 1))
        cin = planes * expansion
    return nn.Sequential(*blocks)


class DAPPMBranch(nn.Module):
    """``down_scale = [pool,] bn, relu, conv 1x1`` (no pool at stride 1, the global mean at
    stride 0, else a ``kernel_size`` average pool over ``stride`` pixels of zero padding that
    count), upsampled back, then, for every branch but
    the first, ``process = bn, relu, conv 3x3`` of the sum with the previous branch."""

    def __init__(self, kernel_size: int, stride: int, in_planes: int, branch_planes: int, first: bool):
        super().__init__()
        layers = []
        if stride == 0:
            layers.append(nn.AdaptiveAvgPool2d(1))
        elif stride > 1:
            layers.append(nn.AvgPool2d(kernel_size, stride, padding=stride, count_include_pad=True))
        layers += [nn.BatchNorm2d(in_planes, momentum=0.1), nn.ReLU(),
                   nn.Conv2d(in_planes, branch_planes, 1, bias=False)]
        self.down_scale = nn.Sequential(*layers)
        self.process: Optional[nn.Sequential] = None
        if not first:
            self.process = nn.Sequential(nn.BatchNorm2d(branch_planes, momentum=0.1), nn.ReLU(),
                                         nn.Conv2d(branch_planes, branch_planes, 3, padding=1, bias=False))

    def forward(self, x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = resize_to(self.down_scale(x), *x.shape[-2:])
        if self.process is not None:
            y = self.process(y + prev)
        return y


class DAPPM(nn.Module):
    """Deep Aggregation Pyramid Pooling Module: five chained branches concatenated, compressed
    to ``out_planes``, plus a 1x1 shortcut."""

    def __init__(self, in_planes: int, branch_planes: int, out_planes: int,
                 kernel_sizes: Tuple[int, ...] = (1, 5, 9, 17, 0), strides: Tuple[int, ...] = (1, 2, 4, 8, 0)):
        super().__init__()
        self.branches = nn.ModuleList([DAPPMBranch(k, s, in_planes, branch_planes, first=i == 0)
                                       for i, (k, s) in enumerate(zip(kernel_sizes, strides))])
        cat = branch_planes * len(kernel_sizes)
        self.compression = nn.Sequential(nn.BatchNorm2d(cat, momentum=0.1), nn.ReLU(),
                                         nn.Conv2d(cat, out_planes, 1, bias=False))
        self.shortcut = nn.Sequential(nn.BatchNorm2d(in_planes, momentum=0.1), nn.ReLU(),
                                      nn.Conv2d(in_planes, out_planes, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for branch in self.branches:
            outs.append(branch(x, outs[-1] if outs else None))
        return self.compression(torch.cat(outs, dim=1)) + self.shortcut(x)


class DDRSegmentHead(nn.Module):
    """BN, ReLU, conv 3x3, BN, ReLU, conv 1x1 (with bias), upsampled by ``scale_factor``."""

    def __init__(self, in_planes: int, inter_planes: int, out_planes: int, scale_factor: int):
        super().__init__()
        self.scale_factor = scale_factor
        self.bn1 = nn.BatchNorm2d(in_planes, momentum=0.1)
        self.conv1 = nn.Conv2d(in_planes, inter_planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(inter_planes, momentum=0.1)
        self.conv2 = nn.Conv2d(inter_planes, out_planes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(F.relu(self.bn1(x)))
        x = self.conv2(F.relu(self.bn2(x)))
        return resize_to(x, x.shape[-2] * self.scale_factor, x.shape[-1] * self.scale_factor)


@dataclasses.dataclass(frozen=True)
class DDRNetCfg:
    num_classes: int = 19
    planes: int = 64
    highres_planes: int = 128
    head_planes: int = 128
    spp_planes: int = 128
    layers: Tuple[int, ...] = (2, 2, 2, 2, 1, 2, 2, 1)  # the trunk's layer1-4, then layer5, layer3/4/5_skip
    layer3_repeats: int = 1
    layer5_bottleneck_expansion: int = 2
    use_aux_heads: bool = False


DDRNET_23_CFG = DDRNetCfg()
DDRNET_23_SLIM_CFG = DDRNetCfg(planes=32, highres_planes=64, head_planes=64)
DDRNET_39_CFG = DDRNetCfg(layers=(3, 4, 3, 3, 1, 3, 3, 1), head_planes=256, layer3_repeats=2)


class _Backbone(nn.Module):
    def __init__(self, w: int, layers: Tuple[int, ...], layer3_repeats: int):
        super().__init__()
        self.stem = nn.Sequential(conv_bn(3, w, 3, 2, add_relu=True, bias=True),
                                  conv_bn(w, w, 3, 2, add_relu=True, bias=True))
        self.layer1 = make_layer("basic", w, w, layers[0], 1, 1)
        self.layer2 = make_layer("basic", w, w * 2, layers[1], 2, 1)
        self.layer3 = nn.ModuleList([make_layer("basic", w * 2 if i == 0 else w * 4, w * 4, layers[2],
                                                2 if i == 0 else 1, 1) for i in range(layer3_repeats)])
        self.layer4 = make_layer("basic", w * 4, w * 8, layers[3], 2, 1)


class DDRNet(nn.Module):
    """The dual-resolution network: a low-resolution trunk and a 1/8 high-resolution branch,
    fused both ways after layer 3 (each repeat) and layer 4, the DAPPM context at 1/64, and
    the segmentation head on their sum at 1/8, upsampled to the input size."""

    def __init__(self, cfg: DDRNetCfg):
        super().__init__()
        self.cfg = cfg
        w, hp, exp = cfg.planes, cfg.highres_planes, cfg.layer5_bottleneck_expansion
        add = cfg.layers[4:]
        self._backbone = _Backbone(w, cfg.layers, cfg.layer3_repeats)
        self.layer3_skip = nn.ModuleList([make_layer("basic", w * 2 if i == 0 else hp, hp, add[1], 1, 1)
                                          for i in range(cfg.layer3_repeats)])
        self.down3 = nn.ModuleList([conv_bn(hp, w * 4, 3, 2) for _ in range(cfg.layer3_repeats)])
        self.compression3 = nn.ModuleList([conv_bn(w * 4, hp, 1) for _ in range(cfg.layer3_repeats)])
        self.layer4_skip = make_layer("basic", hp, hp, add[2], 1, 1)
        self.down4 = nn.Sequential(conv_bn(hp, hp * 2, 3, 2, add_relu=True), conv_bn(hp * 2, w * 8, 3, 2))
        self.compression4 = conv_bn(w * 8, hp, 1)
        self.layer5_skip = make_layer("bottleneck", hp, hp, add[3], 1, exp)
        self.layer5 = make_layer("bottleneck", w * 8, w * 8, add[0], 2, exp)
        self.spp = DAPPM(w * 8 * exp, cfg.spp_planes, hp * exp)
        self.final_layer = DDRSegmentHead(hp * exp, cfg.head_planes, cfg.num_classes, 8)
        if cfg.use_aux_heads:
            self.seghead_extra = DDRSegmentHead(hp, cfg.head_planes, cfg.num_classes, 8)

    def reset_parameters(self, generator: torch.Generator) -> "DDRNet":
        return reset_segmentation_parameters(self, generator)

    def forward(self, x: torch.Tensor):
        out_h, out_w = x.shape[-2] // 8, x.shape[-1] // 8
        bb = self._backbone
        x = bb.layer1(bb.stem(x))
        x = bb.layer2(F.relu(x))
        x_skip = x
        for layer3, layer3_skip, down3, compression3 in zip(bb.layer3, self.layer3_skip, self.down3,
                                                            self.compression3):
            out_layer3 = layer3(F.relu(x))
            out_layer3_skip = layer3_skip(F.relu(x_skip))
            x = out_layer3 + down3(F.relu(out_layer3_skip))
            x_skip = out_layer3_skip + resize_to(compression3(F.relu(out_layer3)), out_h, out_w)
        aux_feat = x_skip

        out_layer4 = bb.layer4(F.relu(x))
        out_layer4_skip = self.layer4_skip(F.relu(x_skip))
        x = out_layer4 + self.down4(F.relu(out_layer4_skip))
        x_skip = out_layer4_skip + resize_to(self.compression4(F.relu(out_layer4)), out_h, out_w)

        out_layer5_skip = self.layer5_skip(F.relu(x_skip))
        x = resize_to(self.spp(self.layer5(F.relu(x))), out_h, out_w)
        main = self.final_layer(x + out_layer5_skip)
        if not (self.cfg.use_aux_heads and self.training):
            return main
        return main, self.seghead_extra(aux_feat)
