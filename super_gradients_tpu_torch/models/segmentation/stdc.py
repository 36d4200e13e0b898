"""STDC backbone, STDC classification and STDC segmentation, NCHW (counterpart of
``super_gradients_tpu/models/segmentation/stdc.py``).

Attribute names are the original super-gradients ones, so that
``conversion/from_jax.py::STDC_RULES`` (segmentation) and ``STDC_CLS_RULES``
(classification) carry the JAX parameters across: the backbone's stages are
``backbone.stages.block_s{2,4,8,16,32}``, every conv-BN-ReLU nests under ``seq``, the
stride-2 STDC block's second step is ``conv_list.1 = Sequential(depthwise, conv)``, the
segmentation model's context path is ``cp`` and each head is
``Sequential(SegmentationHead(seg_head=[conv, dropout, conv]), upsample)``.

As in the JAX modules: the stride-2 skip of an STDC block is a 3x3 stride-2 average pool
over one pixel of zero padding that counts the padding; the context path upsamples with
``nearest`` (torch's ``nearest-exact``, which is what ``jax.image.resize`` does) and the
heads with the align-corners bilinear grid. In train mode the segmentation model returns
``(main, aux32, aux16, detail8)``, each at the input size; in eval mode the main map
alone, and the auxiliary heads are not computed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.modules.blocks import ConvBNReLU


def upsample(x: torch.Tensor, scale: int, method: str = "nearest") -> torch.Tensor:
    """Upsample an NCHW tensor by an integer ``scale`` as the JAX ``_upsample`` does:
    ``"nearest"`` is ``jax.image.resize(nearest)`` (half-pixel centres: torch's
    ``nearest-exact``), ``"bilinear_ac"`` the align-corners grid and ``"bilinear"`` the
    half-pixel one."""
    size = (x.shape[-2] * scale, x.shape[-1] * scale)
    if method == "nearest":
        return F.interpolate(x, size=size, mode="nearest-exact")
    return F.interpolate(x, size=size, mode="bilinear", align_corners=method == "bilinear_ac")


def resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(bilinear)`` of an upsampling to ``(h, w)``: the half-pixel grid, no
    antialias (``jax.image.resize`` antialiases only when it shrinks)."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class Upsample(nn.Module):
    def __init__(self, scale: int, method: str):
        super().__init__()
        self.scale, self.method = scale, method

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample(x, self.scale, self.method)


class SeededDropout(nn.Module):
    """Dropout whose masks come from an explicit ``torch.Generator`` seeded with
    ``seed + n`` at its n-th train-mode call, on the input's device, so a run is
    reproducible from the seed; the identity in eval mode or at ``p == 0``."""

    def __init__(self, p: float, seed: int = 0):
        super().__init__()
        self.p, self.seed, self.calls = float(p), int(seed), 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        generator = torch.Generator(device=x.device).manual_seed(self.seed + self.calls)
        self.calls += 1
        keep = torch.rand(self.mask_shape(x), generator=generator, device=x.device) >= self.p
        return x * keep / (1.0 - self.p)

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape)


class SeededChannelDropout(SeededDropout):
    """:class:`SeededDropout` of whole channels: one draw an image and a channel, the same over
    H and W (torch's ``Dropout2d``, flax's ``Dropout(broadcast_dims=(1, 2))`` of an NHWC map)."""

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return (*x.shape[:2], *(1,) * (x.dim() - 2))


class STDCBlock(nn.Module):
    """Short-term dense concatenate block: a 1x1 conv to half the width, then ``steps - 1``
    3x3 convs each halving the width but the last; the outputs concatenated."""

    def __init__(self, in_channels: int, out_channels: int, steps: int = 4, stride: int = 1):
        super().__init__()
        self.stride = stride
        half = out_channels // 2
        self.conv_list = nn.ModuleList([ConvBNReLU(in_channels, half, 1)])
        mid, cin = half, half
        for idx in range(1, steps):
            if idx < steps - 1:
                mid //= 2
            conv = ConvBNReLU(cin, mid, 3)
            if idx == 1 and stride == 2:  # the depthwise stride-2 conv before the second step
                conv = nn.Sequential(ConvBNReLU(cin, cin, 3, stride=2, groups=cin, use_activation=False), conv)
            self.conv_list.append(conv)
            cin = mid

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_list[0](x)
        out = [x if self.stride == 1 else F.avg_pool2d(x, 3, 2, padding=1, count_include_pad=True)]
        y = x
        for conv in self.conv_list[1:]:
            y = conv(y)
            out.append(y)
        return torch.cat(out, dim=1)


@dataclasses.dataclass(frozen=True)
class STDCBackboneCfg:
    block_types: Tuple[str, ...] = ("conv", "conv", "stdc", "stdc", "stdc")
    ch_widths: Tuple[int, ...] = (32, 64, 256, 512, 1024)
    num_blocks: Tuple[int, ...] = (1, 1, 2, 2, 2)
    stdc_steps: int = 4
    out_down_ratios: Tuple[int, ...] = (8, 16, 32)


STDC1_CFG = STDCBackboneCfg()
STDC2_CFG = STDCBackboneCfg(num_blocks=(1, 1, 4, 5, 3))


class STDCBackbone(nn.Module):
    """Five stages at strides 2-32 (``stages.block_s{ratio}``), each a ``Sequential`` of
    blocks of which the first has stride 2; returns the outputs at ``out_down_ratios``."""

    def __init__(self, cfg: STDCBackboneCfg):
        super().__init__()
        self.out_down_ratios = tuple(cfg.out_down_ratios)
        self.stages = nn.ModuleDict()
        self.out_channels: List[int] = []
        cin, ratio = 3, 2  # RGB in
        for btype, width, blocks in zip(cfg.block_types, cfg.ch_widths, cfg.num_blocks):
            stage = []
            for bi in range(blocks):
                stride = 2 if bi == 0 else 1
                if btype == "conv":
                    stage.append(ConvBNReLU(cin, width, 3, stride=stride))
                else:
                    stage.append(STDCBlock(cin, width, cfg.stdc_steps, stride))
                cin = width
            self.stages[f"block_s{ratio}"] = nn.Sequential(*stage)
            if ratio in self.out_down_ratios:
                self.out_channels.append(width)
            ratio *= 2

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outputs = []
        for name, stage in self.stages.items():
            x = stage(x)
            if int(name[len("block_s"):]) in self.out_down_ratios:
                outputs.append(x)
        return tuple(outputs)


@torch.no_grad()
def reset_segmentation_parameters(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init: He-normal conv weights, LeCun-normal ``Linear`` weights, zero biases
    (flax's default), unit BN and LayerNorm affine and (0, 1) running stats."""
    for module in net.modules():
        if isinstance(module, nn.Conv2d):
            fan_in = module.weight[0].numel()
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in))
        elif isinstance(module, nn.Linear):
            fan_in = module.weight.shape[1]
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * math.sqrt(1.0 / fan_in))
        elif isinstance(module, (nn.BatchNorm2d, nn.LayerNorm)):
            module.reset_parameters()
        if isinstance(module, (nn.Conv2d, nn.Linear)) and module.bias is not None:
            module.bias.zero_()
    return net


class STDCClassification(nn.Module):
    """The STDC backbone with the squared-feature classifier: ``conv_last(x) ** 2``, a
    global mean, ``fc``, ReLU, dropout, ``linear`` (both without bias)."""

    def __init__(self, backbone_cfg: STDCBackboneCfg = STDC1_CFG, num_classes: int = 1000, dropout: float = 0.2):
        super().__init__()
        self.backbone = STDCBackbone(backbone_cfg)
        cin = self.backbone.out_channels[-1]
        head = max(1024, cin)
        self.conv_last = ConvBNReLU(cin, head, 1)
        self.fc = nn.Linear(head, head, bias=False)
        self.dropout = SeededDropout(dropout)
        self.linear = nn.Linear(head, num_classes, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> "STDCClassification":
        return reset_segmentation_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv_last(self.backbone(x)[-1])
        out = F.relu(self.fc((out ** 2).mean(dim=(2, 3))))
        return self.linear(self.dropout(out))


class AttentionRefinementModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_first = ConvBNReLU(in_channels, out_channels, 3)
        self.attention_block = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                             ConvBNReLU(out_channels, out_channels, 1, use_activation=False),
                                             nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_first(x)
        return x * self.attention_block(x)


class FeatureFusionModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.pw_conv = ConvBNReLU(in_channels, out_channels, 1)
        self.attention_block = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            ConvBNReLU(out_channels, out_channels // 4, 1, use_normalization=False),
            nn.Conv2d(out_channels // 4, out_channels, 1, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, spatial_feats: torch.Tensor, context_feats: torch.Tensor) -> torch.Tensor:
        feat = self.pw_conv(torch.cat([spatial_feats, context_feats], dim=1))
        return feat * self.attention_block(feat) + feat


class SegmentationHead(nn.Module):
    """``seg_head = Sequential(ConvBNReLU 3x3, dropout, 1x1 conv)``."""

    def __init__(self, in_channels: int, mid_channels: int, num_classes: int, dropout: float = 0.0):
        super().__init__()
        self.seg_head = nn.Sequential(ConvBNReLU(in_channels, mid_channels, 3), SeededDropout(dropout),
                                      nn.Conv2d(mid_channels, num_classes, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.seg_head(x)


def head_with_upsample(in_channels: int, mid_channels: int, num_classes: int, dropout: float, scale: int,
                       method: str) -> nn.Sequential:
    """``Sequential(SegmentationHead, Upsample)``: the layout of every head of the family."""
    return nn.Sequential(SegmentationHead(in_channels, mid_channels, num_classes, dropout), Upsample(scale, method))


@dataclasses.dataclass(frozen=True)
class STDCSegCfg:
    backbone: STDCBackboneCfg = STDC1_CFG
    num_classes: int = 19
    context_fuse_channels: int = 128
    ffm_channels: int = 256
    aux_head_channels: int = 64
    detail_head_channels: int = 64
    use_aux_heads: bool = True
    dropout: float = 0.2


class ContextEmbedding(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.context_embedding = nn.Sequential(nn.AdaptiveAvgPool2d(1), ConvBNReLU(in_channels, out_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.context_embedding(x)


class ContextPath(nn.Module):
    """The backbone and the attention-refined, upsampled stride-32 and stride-16 context;
    returns ``(feat8, feat16, feat32, f16_up)``."""

    def __init__(self, cfg: STDCSegCfg):
        super().__init__()
        fuse = cfg.context_fuse_channels
        self.backbone = STDCBackbone(cfg.backbone)
        c8, c16, c32 = self.backbone.out_channels
        self.context_embedding = ContextEmbedding(c32, fuse)
        self.arm32 = AttentionRefinementModule(c32, fuse)
        self.upsample32 = nn.Sequential(Upsample(2, "nearest"), ConvBNReLU(fuse, fuse, 3))
        self.arm16 = AttentionRefinementModule(c16, fuse)
        self.upsample16 = nn.Sequential(Upsample(2, "nearest"), ConvBNReLU(fuse, fuse, 3))

    def forward(self, x: torch.Tensor):
        feat8, feat16, feat32 = self.backbone(x)
        f32 = self.arm32(feat32) + self.context_embedding(feat32)
        f16 = self.arm16(feat16) + self.upsample32(f32)
        return feat8, feat16, feat32, self.upsample16(f16)


class STDCSegmentation(nn.Module):
    """BiSeNet-style STDC segmentation: context path, feature fusion of the stride-8
    features with the upsampled context, the segmentation head upsampled x8; in train mode
    also the stride-32 / stride-16 auxiliary heads and the stride-8 detail head."""

    def __init__(self, cfg: STDCSegCfg):
        super().__init__()
        self.cfg = cfg
        nc, drop = cfg.num_classes, cfg.dropout
        self.cp = ContextPath(cfg)
        c8, c16, c32 = self.cp.backbone.out_channels
        self.ffm = FeatureFusionModule(c8 + cfg.context_fuse_channels, cfg.ffm_channels)
        self.segmentation_head = head_with_upsample(cfg.ffm_channels, cfg.ffm_channels, nc, drop, 8, "bilinear_ac")
        if cfg.use_aux_heads:
            self.aux_head_s16 = head_with_upsample(c16, cfg.aux_head_channels, nc, drop, 16, "bilinear_ac")
            self.aux_head_s32 = head_with_upsample(c32, cfg.aux_head_channels, nc, drop, 32, "bilinear_ac")
            self.detail_head8 = head_with_upsample(c8, cfg.detail_head_channels, 1, drop, 8, "bilinear_ac")

    def reset_parameters(self, generator: torch.Generator) -> "STDCSegmentation":
        return reset_segmentation_parameters(self, generator)

    def forward(self, x: torch.Tensor):
        feat8, feat16, feat32, f16_up = self.cp(x)
        main = self.segmentation_head(self.ffm(feat8, f16_up))
        if not (self.cfg.use_aux_heads and self.training):
            return main
        return main, self.aux_head_s32(feat32), self.aux_head_s16(feat16), self.detail_head8(feat8)

