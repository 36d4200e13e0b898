"""RegSeg48, NCHW (counterpart of ``super_gradients_tpu/models/segmentation/regseg.py``).

Attribute names are the original super-gradients ones, so that
``conversion/from_jax.py::REGSEG_RULES`` carries the JAX parameters across: ``stem.seq``, the
blocks under ``backbone.stages.{i}`` named after their geometry
(``DBlock_in{cin}_out{oc}_d{dilations}_gw{group_width}_s{stride}_se{se_ratio}#{index}``, see
:func:`dblock_name`), a block's ``d_block_path = [conv1, dilated conv(s), bn2, relu, SE,
conv3]`` and ``shortcut.shortcut = [pool, conv-BN]``, ``decoder.projections`` /
``decoder.conv_bn_relu`` and ``head.head = [conv-BN-ReLU, conv]``.

As in the JAX modules: the stem conv has a bias; ``bn2`` has flax's default momentum 0.99
(torch's 0.01), every other BN torch's 0.1; a block with several dilations splits its
channels evenly among grouped 3x3 convs (``group_width`` channels a group) and concatenates
them; the SE squeeze width is ``cin // se_ratio`` of the block's *input* channels; a stride-2
shortcut is a 2x2 average pool (floor) then a 1x1 conv-BN; the decoder upsamples with the
align-corners grid and the head by 4 with the half-pixel one.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.segmentation.stdc import reset_segmentation_parameters, resize_to, upsample
from super_gradients_tpu_torch.modules.blocks import ConvBNReLU

# a stage's blocks: (out_channels, dilations, group_width, stride, se_ratio)
REGSEG48_STAGES = (
    ((48, (1,), 16, 2, 4),),
    ((128, (1,), 16, 2, 4), (128, (1,), 16, 1, 4), (128, (1,), 16, 1, 4)),
    (
        (256, (1,), 16, 2, 4),
        (256, (1,), 16, 1, 4),
        (256, (1, 2), 16, 1, 4),
        *(((256, (1, 4), 16, 1, 4),) * 4),
        *(((256, (1, 14), 16, 1, 4),) * 6),
        (320, (1, 14), 16, 1, 4),
    ),
)
STEM_CHANNELS = 32


def dblock_name(cin: int, block: Tuple, index: int) -> str:
    """The original's name of a stage's ``index``-th block, which spells out its geometry."""
    oc, dilations, group_width, stride, se_ratio = block
    return f"DBlock_in{cin}_out{oc}_d{list(dilations)}_gw{group_width}_s{stride}_se{se_ratio}#{index}"


def dblock_names(stages: Sequence = REGSEG48_STAGES) -> dict:
    """``{(stage, block): name}`` for every block of ``stages``."""
    names, cin = {}, STEM_CHANNELS
    for si, stage in enumerate(stages):
        for bi, block in enumerate(stage):
            names[(si, bi)] = dblock_name(cin, block, bi)
            cin = block[0]
    return names


class SplitDilatedConv(nn.Module):
    """The channels split evenly among grouped 3x3 convs of the given dilations, concatenated."""

    def __init__(self, channels: int, dilations: Sequence[int], group_width: int, stride: int):
        super().__init__()
        gc = channels // len(dilations)
        self.convs = nn.ModuleList([nn.Conv2d(gc, gc, 3, stride, d, dilation=d, groups=gc // group_width, bias=False)
                                    for d in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        splits = torch.chunk(x, len(self.convs), dim=1)
        return torch.cat([conv(s) for conv, s in zip(self.convs, splits)], dim=1)


class SEBlock(nn.Module):
    """``se_block = [global mean, conv 1x1, relu, conv 1x1, sigmoid]`` gating its input."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.se_block = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(channels, squeeze, 1), nn.ReLU(),
                                      nn.Conv2d(squeeze, channels, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.se_block(x)


class AdaptiveShortcut(nn.Module):
    """The identity, or ``shortcut = [2x2 average pool or identity, conv-BN 1x1]`` where the
    stride or the width changes."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.shortcut = nn.Sequential()
        if cin != cout or stride > 1:
            pool = nn.AvgPool2d(2, 2) if stride > 1 else nn.Identity()
            self.shortcut = nn.Sequential(pool, ConvBNReLU(cin, cout, 1, use_activation=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x)


class DBlock(nn.Module):
    def __init__(self, cin: int, out_channels: int, dilations: Sequence[int], group_width: int, stride: int,
                 se_ratio: int = 4):
        super().__init__()
        oc = out_channels
        if len(dilations) == 1:
            d = dilations[0]
            dconv = nn.Conv2d(oc, oc, 3, stride, d, dilation=d, groups=oc // group_width, bias=False)
        else:
            dconv = SplitDilatedConv(oc, dilations, group_width, stride)
        self.d_block_path = nn.Sequential(
            ConvBNReLU(cin, oc, 1),
            dconv,
            nn.BatchNorm2d(oc, momentum=0.01),
            nn.ReLU(),
            SEBlock(oc, cin // se_ratio),
            ConvBNReLU(oc, oc, 1, use_activation=False),
        )
        self.shortcut = AdaptiveShortcut(cin, oc, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.d_block_path(x) + self.shortcut(x))


class RegSegDecoder(nn.Module):
    """Projections of the three stages; the 1/16 one upsampled onto the 1/8 one, a 3x3
    conv-BN-ReLU, upsampled onto the 1/4 one and concatenated with it."""

    def __init__(self, stage_channels: Sequence[int], projection_out_channels: Sequence[int]):
        super().__init__()
        p = projection_out_channels
        self.projections = nn.ModuleList([ConvBNReLU(c, o, 1) for c, o in zip(stage_channels, p)])
        self.conv_bn_relu = ConvBNReLU(p[1], p[1] // 2, 3)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        y = self.projections[1](feats[1]) + upsample(self.projections[2](feats[2]), 2, "bilinear_ac")
        y = upsample(self.conv_bn_relu(y), 2, "bilinear_ac")
        return torch.cat([y, self.projections[0](feats[0])], dim=1)


class RegSegHead(nn.Module):
    def __init__(self, cin: int, mid: int, num_classes: int):
        super().__init__()
        self.head = nn.Sequential(ConvBNReLU(cin, mid, 3), nn.Conv2d(mid, num_classes, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x)


@dataclasses.dataclass(frozen=True)
class RegSegCfg:
    num_classes: int = 19
    stages: Tuple = REGSEG48_STAGES
    projection_out_channels: Tuple[int, ...] = (8, 128, 128)
    head_mid_channels: int = 64


class _RegSegBackbone(nn.Module):
    def __init__(self, stages: Sequence):
        super().__init__()
        names = dblock_names(stages)
        self.stages = nn.ModuleList()
        cin = STEM_CHANNELS
        for si, stage in enumerate(stages):
            blocks = OrderedDict()
            for bi, (oc, dil, gw, stride, se) in enumerate(stage):
                blocks[names[(si, bi)]] = DBlock(cin, oc, dil, gw, stride, se)
                cin = oc
            self.stages.append(nn.Sequential(blocks))


class RegSeg(nn.Module):
    """The stride-2 stem, three stages of D blocks (1/4, 1/8, 1/16), the decoder and the head,
    upsampled by 4 to the input size."""

    def __init__(self, cfg: RegSegCfg):
        super().__init__()
        self.cfg = cfg
        self.stem = ConvBNReLU(3, STEM_CHANNELS, 3, stride=2, bias=True)
        self.backbone = _RegSegBackbone(cfg.stages)
        p = cfg.projection_out_channels
        self.decoder = RegSegDecoder([stage[-1][0] for stage in cfg.stages], p)
        self.head = RegSegHead(p[1] // 2 + p[0], cfg.head_mid_channels, cfg.num_classes)

    def reset_parameters(self, generator: torch.Generator) -> "RegSeg":
        return reset_segmentation_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        feats = []
        for stage in self.backbone.stages:
            x = stage(x)
            feats.append(x)
        y = self.head(self.decoder(feats))
        return resize_to(y, y.shape[-2] * 4, y.shape[-1] * 4)
