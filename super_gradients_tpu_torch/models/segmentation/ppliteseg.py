"""PP-LiteSeg T / B, NCHW (counterpart of ``super_gradients_tpu/models/segmentation/ppliteseg.py``).

Attribute names are the original super-gradients ones, so that
``conversion/from_jax.py::PPLITESEG_RULES`` carries the JAX parameters across:
``encoder.backbone`` (the STDC backbone), ``encoder.context_module`` (SPPM:
``branches.{i} = Sequential(pool, conv)`` and ``conv_out``), ``encoder.proj_convs``,
``decoder.up_stages`` (UAFM), ``seg_head`` and ``aux_heads``.

The JAX pooling and resizes are not torch's ``adaptive_avg_pool2d``: a pool to size 1
is a mean, a pool that divides the map an ``avg_pool`` with kernel = stride, and any other
size falls back to ``jax.image.resize(linear)``, which antialiases when it shrinks. Both
that fallback and SPPM's resize back to the map's size are :func:`resize_linear`
(``F.interpolate(bilinear, antialias=True)``, the same kernel as ``jax.image.resize``
either way). UAFM's and the heads' upsampling is the half-pixel bilinear grid.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.segmentation.stdc import (
    STDC1_CFG,
    STDC2_CFG,
    STDCBackbone,
    STDCBackboneCfg,
    head_with_upsample,
    reset_segmentation_parameters,
    upsample,
)
from super_gradients_tpu_torch.modules.blocks import ConvBNReLU


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="linear")`` of an NCHW tensor: half-pixel bilinear,
    antialiased where it shrinks."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """The JAX ``_adaptive_avg_pool``: a mean, an ``avg_pool`` for divisible sizes, else
    :func:`resize_linear`."""
    h, w = x.shape[-2:]
    if out_size == 1:
        return x.mean(dim=(2, 3), keepdim=True)
    if h >= out_size and w >= out_size and h % out_size == 0 and w % out_size == 0:
        kh, kw = h // out_size, w // out_size
        return F.avg_pool2d(x, (kh, kw), (kh, kw))
    return resize_linear(x, (out_size, out_size))


class AdaptiveAvgPool(nn.Module):
    def __init__(self, out_size: int):
        super().__init__()
        self.out_size = out_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool(x, self.out_size)


class SPPM(nn.Module):
    """Simple pyramid pooling: each branch pools, convolves and resizes back; the sum
    goes through ``conv_out``."""

    def __init__(self, in_channels: int, inter_channels: int, out_channels: int, pool_sizes: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.branches = nn.ModuleList(
            [nn.Sequential(AdaptiveAvgPool(ps), ConvBNReLU(in_channels, inter_channels, 1)) for ps in pool_sizes])
        self.conv_out = ConvBNReLU(inter_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = tuple(x.shape[-2:])
        out = None
        for branch in self.branches:
            y = resize_linear(branch(x), size)
            out = y if out is None else out + y
        return self.conv_out(out)


class UAFM(nn.Module):
    """Unified attention fusion: ``x`` upsampled, ``skip`` projected where its width
    differs, a spatial attention from the channel means and maxima of both."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int, up_factor: int):
        super().__init__()
        self.up_factor = up_factor
        if skip_channels != in_channels:
            self.proj_skip = ConvBNReLU(skip_channels, in_channels, 3)
        self.conv_atten = nn.Sequential(ConvBNReLU(4, 2, 3), ConvBNReLU(2, 1, 3, use_activation=False))
        self.conv_out = ConvBNReLU(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self.up_factor != 1:
            x = upsample(x, self.up_factor, "bilinear")
        if hasattr(self, "proj_skip"):
            skip = self.proj_skip(skip)
        atten = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True),
                           skip.mean(dim=1, keepdim=True), skip.amax(dim=1, keepdim=True)], dim=1)
        atten = torch.sigmoid(self.conv_atten(atten))
        return self.conv_out(x * atten + skip * (1 - atten))


@dataclasses.dataclass(frozen=True)
class PPLiteSegCfg:
    backbone: STDCBackboneCfg = STDC1_CFG
    num_classes: int = 19
    projection_channels: Tuple[int, ...] = (64, 128, 128)
    sppm_inter_channels: int = 128
    sppm_out_channels: int = 128
    sppm_pool_sizes: Tuple[int, ...] = (1, 2, 4)
    decoder_up_factors: Tuple[int, ...] = (1, 2, 2)
    decoder_channels: Tuple[int, ...] = (128, 64, 32)
    head_mid_channels: int = 32
    dropout: float = 0.0
    use_aux_heads: bool = False
    aux_hidden_channels: Tuple[int, ...] = (32, 64, 64)
    aux_scale_factors: Tuple[int, ...] = (8, 16, 32)


PP_LITE_T_CFG = PPLiteSegCfg()
PP_LITE_B_CFG = PPLiteSegCfg(
    backbone=STDC2_CFG,
    projection_channels=(96, 128, 128),
    decoder_channels=(128, 96, 64),
    head_mid_channels=64,
)


class PPLiteSegEncoder(nn.Module):
    def __init__(self, cfg: PPLiteSegCfg):
        super().__init__()
        self.backbone = STDCBackbone(cfg.backbone)
        chans = self.backbone.out_channels
        self.context_module = SPPM(chans[-1], cfg.sppm_inter_channels, cfg.sppm_out_channels, cfg.sppm_pool_sizes)
        self.proj_convs = nn.ModuleList([ConvBNReLU(c, pc, 3) for c, pc in zip(chans, cfg.projection_channels)])

    def forward(self, x: torch.Tensor):
        feats = self.backbone(x)
        projected = [conv(f) for conv, f in zip(self.proj_convs, feats)]
        return feats, projected, self.context_module(feats[-1])


class PPLiteSegDecoder(nn.Module):
    def __init__(self, cfg: PPLiteSegCfg):
        super().__init__()
        stages, in_ch = [], cfg.sppm_out_channels
        for skip_ch, up, out_ch in zip(reversed(cfg.projection_channels), cfg.decoder_up_factors, cfg.decoder_channels):
            stages.append(UAFM(in_ch, skip_ch, out_ch, up))
            in_ch = out_ch
        self.up_stages = nn.ModuleList(stages)

    def forward(self, context: torch.Tensor, projected) -> torch.Tensor:
        y = context
        for stage, skip in zip(self.up_stages, reversed(projected)):
            y = stage(y, skip)
        return y


class PPLiteSeg(nn.Module):
    """STDC encoder + SPPM context + UAFM decoder, the head upsampled x8; with
    ``use_aux_heads``, train mode also returns a head on each backbone output."""

    def __init__(self, cfg: PPLiteSegCfg):
        super().__init__()
        self.cfg = cfg
        nc, drop = cfg.num_classes, cfg.dropout
        self.encoder = PPLiteSegEncoder(cfg)
        self.decoder = PPLiteSegDecoder(cfg)
        self.seg_head = head_with_upsample(cfg.decoder_channels[-1], cfg.head_mid_channels, nc, drop, 8, "bilinear")
        if cfg.use_aux_heads:
            self.aux_heads = nn.ModuleList([
                head_with_upsample(c, hid, nc, drop, sf, "bilinear")
                for c, hid, sf in zip(self.encoder.backbone.out_channels, cfg.aux_hidden_channels, cfg.aux_scale_factors)
            ])

    def reset_parameters(self, generator: torch.Generator) -> "PPLiteSeg":
        return reset_segmentation_parameters(self, generator)

    def forward(self, x: torch.Tensor):
        feats, projected, context = self.encoder(x)
        main = self.seg_head(self.decoder(context, projected))
        if not (self.cfg.use_aux_heads and self.training):
            return main
        return (main, *(head(f) for head, f in zip(self.aux_heads, feats)))
