"""UNet, its classifier and SegFormer B0-B5, NCHW (counterpart of
``super_gradients_tpu/models/segmentation/unet_segformer.py``).

Attribute names are the original super-gradients ones, so that ``conversion/from_jax.py``
(``unet_rules(cfg)``, ``SEGFORMER_RULES``) carries the JAX parameters across:

- UNet: ``encoder.backbone.stages.{i}.blocks`` (a stride-2 stage's max pool at index 0 before
  its conv-BN-ReLUs), ``decoder.projection_blocks``, ``decoder.up_stages.{i}.last_convs =
  [conv, Sequential(repeats)]`` and ``seg_head.0.seg_head = [conv-BN-ReLU, dropout, conv]``;
  the classifier keeps the encoder's layout under ``backbone.stages`` with an ``fc`` head.
- SegFormer: the MiT encoder under ``_backbone`` (``patch_embed{s}.proj`` / ``.norm``,
  ``block{s}.{b}`` with ``norm1``, ``attn`` (``q``, ``kv``, ``proj``, ``sr``, ``norm``),
  ``norm2``, ``mlp`` (``fc1``, ``dwconv``, ``fc2``), ``norm{s}``), the all-MLP head under
  ``decode_head`` (``linear_c{s}.proj``, ``linear_fuse.seq``, ``linear_pred``), ``s`` from 1.

As in the JAX modules: UNet's max pools floor, its decoder upsamples by 2 with the
half-pixel bilinear grid and its head conv has no bias. SegFormer's LayerNorms have flax's
epsilon 1e-6, its GELU is the tanh approximation, its spatial-reduction conv pads as XLA's
``SAME`` (nothing where the stride divides the map), the fused ``kv`` projection has the
layout ``[b, n, 2, heads, head_dim]``, the attention is ``softmax(q k^T / sqrt(head_dim)) v``
written out (matmul, softmax, matmul), and the decode head concatenates the stages in
reverse order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.segmentation.stdc import SegmentationHead, reset_segmentation_parameters, resize_to
from super_gradients_tpu_torch.modules.blocks import ConvBNReLU, same_pad

LAYER_NORM_EPS = 1e-6  # flax's LayerNorm default


# ------------------------------------------------------------------------------ UNet


@dataclasses.dataclass(frozen=True)
class UNetCfg:
    """The classic UNet assembly: plain conv stages, bilinear-upsample-and-concatenate decoder."""

    num_classes: int = 19
    strides_list: Tuple[int, ...] = (1, 2, 2, 2, 2)
    width_list: Tuple[int, ...] = (64, 128, 256, 512, 512)
    num_blocks_list: Tuple[int, ...] = (2, 2, 2, 2, 2)
    decoder_scale: float = 0.5
    skip_expansion: float = 1.0
    up_block_repeat_list: Tuple[int, ...] = (2, 2, 2, 1)
    min_decoder_channels: int = 1
    final_upsample_factor: int = 1
    head_hidden_channels: int = 0  # 0: the last decoder width
    dropout: float = 0.0


class UNetStage(nn.Module):
    """``blocks = [max pool 2x2 (stride 2 only), conv-BN-ReLU 3x3 ...]``."""

    def __init__(self, cin: int, width: int, num_blocks: int, stride: int):
        super().__init__()
        layers = [nn.MaxPool2d(2, 2)] if stride == 2 else []
        for j in range(num_blocks):
            layers.append(ConvBNReLU(cin if j == 0 else width, width, 3))
        self.blocks = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x)


class UNetEncoderStages(nn.Module):
    def __init__(self, cfg: UNetCfg, num_blocks: Sequence[int]):
        super().__init__()
        self.stages = nn.ModuleList()
        cin = 3
        for stride, width, nb in zip(cfg.strides_list, cfg.width_list, num_blocks):
            self.stages.append(UNetStage(cin, width, nb, stride))
            cin = width


class UNetEncoder(nn.Module):
    def __init__(self, cfg: UNetCfg):
        super().__init__()
        self.backbone = UNetEncoderStages(cfg, cfg.num_blocks_list)


class UpCatBlock(nn.Module):
    """``last_convs = [conv-BN-ReLU, Sequential(the other repeats)]`` after the upsampling and
    the concatenation with the skip."""

    def __init__(self, cin: int, width: int, repeats: int):
        super().__init__()
        self.last_convs = nn.Sequential(ConvBNReLU(cin, width, 3),
                                        nn.Sequential(*[ConvBNReLU(width, width, 3) for _ in range(repeats - 1)]))


class UNetDecoder(nn.Module):
    def __init__(self, cfg: UNetCfg):
        super().__init__()
        skip_channels = list(cfg.width_list)
        self.projection_blocks = nn.ModuleList()  # the skips' 1x1 projections, where skip_expansion != 1
        if cfg.skip_expansion != 1.0:
            proj = [max(int(ch * cfg.skip_expansion), cfg.min_decoder_channels) for ch in cfg.width_list]
            self.projection_blocks = nn.ModuleList([ConvBNReLU(c, p, 1, use_activation=False)
                                                    for c, p in zip(cfg.width_list, proj)])
            skip_channels = proj
        up_channels = [max(int(ch * cfg.decoder_scale), cfg.min_decoder_channels) for ch in cfg.width_list][::-1][1:]
        skip_channels = skip_channels[::-1]
        self.up_stages = nn.ModuleList()
        cin = skip_channels[0]
        for i, (width, repeats) in enumerate(zip(up_channels, cfg.up_block_repeat_list)):
            extra = skip_channels[i + 1] if i + 1 < len(skip_channels) else 0
            self.up_stages.append(UpCatBlock(cin + extra, width, repeats))
            cin = width
        self.out_channels = cin

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(self.projection_blocks):
            feats = [proj(f) for proj, f in zip(self.projection_blocks, feats)]
        skips = feats[::-1]
        x = skips[0]
        for i, stage in enumerate(self.up_stages):
            x = resize_to(x, x.shape[-2] * 2, x.shape[-1] * 2)
            if i + 1 < len(skips):
                x = torch.cat([x, skips[i + 1]], dim=1)
            x = stage.last_convs(x)
        return x


class UNet(nn.Module):
    """The encoder's stage outputs, decoded from the deepest up, then ``seg_head`` (conv-BN-ReLU
    3x3, dropout, conv 1x1 without bias), upsampled by ``final_upsample_factor`` where it is
    above 1."""

    def __init__(self, cfg: UNetCfg):
        super().__init__()
        self.cfg = cfg
        self.encoder = UNetEncoder(cfg)
        self.decoder = UNetDecoder(cfg)
        mid = cfg.head_hidden_channels or self.decoder.out_channels
        self.seg_head = nn.Sequential(SegmentationHead(self.decoder.out_channels, mid, cfg.num_classes, cfg.dropout))

    def reset_parameters(self, generator: torch.Generator) -> "UNet":
        return reset_segmentation_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = []
        for stage in self.encoder.backbone.stages:
            x = stage(x)
            feats.append(x)
        y = self.seg_head(self.decoder(feats))
        f = self.cfg.final_upsample_factor
        return resize_to(y, y.shape[-2] * f, y.shape[-1] * f) if f > 1 else y


class UNetClassifier(nn.Module):
    """The UNet encoder (two conv-BN-ReLUs a stage), a global mean and ``fc``."""

    def __init__(self, cfg: UNetCfg, num_classes: int = 1000):
        super().__init__()
        self.backbone = UNetEncoderStages(cfg, (2,) * len(cfg.width_list))
        self.fc = nn.Linear(cfg.width_list[-1], num_classes)

    def reset_parameters(self, generator: torch.Generator) -> "UNetClassifier":
        return reset_segmentation_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in self.backbone.stages:
            x = stage(x)
        return self.fc(x.mean(dim=(2, 3)))


# ------------------------------------------------------------------------- SegFormer


def tokens_to_map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


class EfficientSelfAttention(nn.Module):
    """Multi-head attention whose keys and values come from the tokens reduced by an
    ``sr_ratio`` x ``sr_ratio`` strided conv (then a LayerNorm) where ``sr_ratio > 1``."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.heads
        kv_in = x
        if self.sr_ratio > 1:
            xm = self.sr(same_pad(tokens_to_map(x, h, w), self.sr_ratio, self.sr_ratio))
            kv_in = self.norm(map_to_tokens(xm))
        kv = self.kv(kv_in).reshape(b, -1, 2, self.heads, hd)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)  # [b, heads, m, hd]
        q = self.q(x).reshape(b, n, self.heads, hd).transpose(1, 2)
        attn = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(hd), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        return self.proj(out)


class MixFFN(nn.Module):
    """``fc1``, a depthwise 3x3 conv over the token map, tanh-GELU, ``fc2``."""

    def __init__(self, dim: int, expansion: int = 4):
        super().__init__()
        hidden = dim * expansion
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        y = map_to_tokens(self.dwconv(tokens_to_map(self.fc1(x), h, w)))
        return self.fc2(F.gelu(y, approximate="tanh"))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = EfficientSelfAttention(dim, heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp = MixFFN(dim)

    def forward(self, t: torch.Tensor, h: int, w: int) -> torch.Tensor:
        t = t + self.attn(self.norm1(t), h, w)
        return t + self.mlp(self.norm2(t), h, w)


class PatchEmbed(nn.Module):
    """An overlapping patch embedding: a strided conv (with bias) and a LayerNorm."""

    def __init__(self, cin: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, stride, patch // 2)
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)


@dataclasses.dataclass(frozen=True)
class SegFormerCfg:
    num_classes: int = 19
    embed_dims: Tuple[int, ...] = (32, 64, 160, 256)  # B0
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    decoder_dim: int = 256


SEGFORMER_B0 = SegFormerCfg()
SEGFORMER_B1 = SegFormerCfg(embed_dims=(64, 128, 320, 512))
SEGFORMER_B2 = SegFormerCfg(embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3), decoder_dim=768)
SEGFORMER_B3 = SegFormerCfg(embed_dims=(64, 128, 320, 512), depths=(3, 4, 18, 3), decoder_dim=768)
SEGFORMER_B4 = SegFormerCfg(embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3), decoder_dim=768)
SEGFORMER_B5 = SegFormerCfg(embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3), decoder_dim=768)


class MiTEncoder(nn.Module):
    """Four stages, each a patch embedding (7x7 stride 4, then 3x3 stride 2), its blocks and a
    LayerNorm; registered 1-based as the original's."""

    def __init__(self, cfg: SegFormerCfg):
        super().__init__()
        cin = 3
        for s, (dim, depth, heads, sr) in enumerate(zip(cfg.embed_dims, cfg.depths, cfg.heads, cfg.sr_ratios), 1):
            patch, stride = (7, 4) if s == 1 else (3, 2)
            setattr(self, f"patch_embed{s}", PatchEmbed(cin, dim, patch, stride))
            setattr(self, f"block{s}", nn.ModuleList([MiTBlock(dim, heads, sr) for _ in range(depth)]))
            setattr(self, f"norm{s}", nn.LayerNorm(dim, eps=LAYER_NORM_EPS))
            cin = dim
        self.num_stages = len(cfg.embed_dims)

    def forward(self, x: torch.Tensor):
        feats = []
        for s in range(1, self.num_stages + 1):
            embed = getattr(self, f"patch_embed{s}")
            x = embed.proj(x)
            h, w = x.shape[-2:]
            t = embed.norm(map_to_tokens(x))
            for block in getattr(self, f"block{s}"):
                t = block(t, h, w)
            x = tokens_to_map(getattr(self, f"norm{s}")(t), h, w)
            feats.append(x)
        return feats


class MLP(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """A per-pixel linear map of an NCHW tensor."""
        return self.proj(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class SegFormerHead(nn.Module):
    def __init__(self, cfg: SegFormerCfg):
        super().__init__()
        self.num_stages = len(cfg.embed_dims)
        for s, dim in enumerate(cfg.embed_dims, 1):
            setattr(self, f"linear_c{s}", MLP(dim, cfg.decoder_dim))
        self.linear_fuse = ConvBNReLU(cfg.decoder_dim * self.num_stages, cfg.decoder_dim, 1)
        self.linear_pred = nn.Conv2d(cfg.decoder_dim, cfg.num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        th, tw = feats[0].shape[-2:]
        ups = []
        for s, f in enumerate(feats, 1):
            y = getattr(self, f"linear_c{s}")(f)
            if y.shape[-2] != th:
                y = resize_to(y, th, tw)
            ups.append(y)
        return self.linear_pred(self.linear_fuse(torch.cat(ups[::-1], dim=1)))


class SegFormer(nn.Module):
    """The MiT encoder and the all-MLP decode head at 1/4, upsampled to the input size."""

    def __init__(self, cfg: SegFormerCfg):
        super().__init__()
        self.cfg = cfg
        self._backbone = MiTEncoder(cfg)
        self.decode_head = SegFormerHead(cfg)

    def reset_parameters(self, generator: torch.Generator) -> "SegFormer":
        return reset_segmentation_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_h, in_w = x.shape[-2:]
        return resize_to(self.decode_head(self._backbone(x)), in_h, in_w)
