"""DPN and PNASNet (the CIFAR forms) and BEiT, NCHW (counterpart of
``super_gradients_tpu/models/classification/dpn_pnasnet_beit.py``).

Attribute names are the original super-gradients ones, which ``conversion/from_jax.py``'s
``DPN_RULES``, ``PNASNET_RULES`` and ``BEIT_RULES`` reach:

- DPN: the stem ``conv1`` / ``bn1``, blocks ``layer{1..4}.{j}`` with ``conv{1,2,3}`` / ``bn{1,2,3}``
  and the first block's ``shortcut`` Sequential (conv, bn), the head ``linear``. A block's output is
  the residual part (the first ``out_planes`` channels of the shortcut plus those of the block) then
  the dense part (the rest of the shortcut's channels, then the rest of the block's), after a ReLU.
- PNASNet-A: the stem ``conv1`` / ``bn1``, cells ``layer1.{i}``, ``layer2`` (stride 2),
  ``layer3.{i}``, ``layer4`` (stride 2), ``layer5.{i}``, each the 7x7 separable conv
  ``sep_conv1.{conv1, bn1}`` plus a 3x3 max pool (padded with ``-inf``) and, where the width
  changes, the 1x1 projection ``conv1`` / ``bn1``, summed then ReLU.
- BEiT: ``patch_embed.proj``, ``cls_token``, ``blocks.{i}`` with the LayerScale ``gamma_1`` /
  ``gamma_2``, ``norm1``, ``attn`` (``qkv`` without bias, ``q_bias`` and ``v_bias``, the
  relative-position-bias table ``relative_position_bias_table`` indexed by
  :func:`gen_relative_position_index`, ``proj``), ``norm2``, ``mlp.fc1`` / ``mlp.fc2``, then
  ``fc_norm`` on the mean of the patch tokens (not the class token) and ``head``.

As in the JAX modules, the BNs the JAX module builds with flax's defaults (PNASNet's separable
convs) take momentum 0.01 in torch's convention, the ``ConvBNAct`` ones 0.1; LayerNorm eps 1e-6
and the tanh GELU; BEiT scales ``q`` before the product and adds the bias table to the logits,
its LayerScale starts at 0.1 and its bias table at zero.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.classification.common import ClassifierNet, global_mean
from super_gradients_tpu_torch.models.classification.vit import LN_EPS, Mlp, PatchEmbed

FLAX_BN_MOMENTUM = 0.01  # flax's BatchNorm default 0.99, in torch's convention


class DPNBottleneck(nn.Module):
    def __init__(self, last_planes: int, in_planes: int, out_planes: int, dense_depth: int, stride: int,
                 first_layer: bool):
        super().__init__()
        self.out_planes = out_planes
        self.conv1 = nn.Conv2d(last_planes, in_planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv2 = nn.Conv2d(in_planes, in_planes, 3, stride, 1, groups=32, bias=False)
        self.bn2 = nn.BatchNorm2d(in_planes)
        self.conv3 = nn.Conv2d(in_planes, out_planes + dense_depth, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_planes + dense_depth)
        self.shortcut = (nn.Sequential(nn.Conv2d(last_planes, out_planes + dense_depth, 1, stride, bias=False),
                                       nn.BatchNorm2d(out_planes + dense_depth)) if first_layer else nn.Sequential())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc, d = self.shortcut(x), self.out_planes
        return F.relu(torch.cat([sc[:, :d] + y[:, :d], sc[:, d:], y[:, d:]], dim=1))


class DPN(ClassifierNet):
    def __init__(self, num_classes: int = 10, in_planes: Sequence[int] = (96, 192, 384, 768),
                 out_planes: Sequence[int] = (256, 512, 1024, 2048), num_blocks: Sequence[int] = (2, 2, 2, 2),
                 dense_depth: Sequence[int] = (16, 32, 24, 128)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        last = 64
        for li in range(4):
            blocks = []
            for bi in range(num_blocks[li]):
                stride = (1 if li == 0 else 2) if bi == 0 else 1
                blocks.append(DPNBottleneck(last, in_planes[li], out_planes[li], dense_depth[li], stride, bi == 0))
                # the shortcut keeps the dense channels it was given and the block adds dense_depth
                last = out_planes[li] + (bi + 2) * dense_depth[li]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.linear = nn.Linear(last, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return self.linear(global_mean(x))


DPN26 = dict(in_planes=(96, 192, 384, 768), out_planes=(256, 512, 1024, 2048), num_blocks=(2, 2, 2, 2),
             dense_depth=(16, 32, 24, 128))
DPN92 = dict(in_planes=(96, 192, 384, 768), out_planes=(256, 512, 1024, 2048), num_blocks=(3, 4, 20, 3),
             dense_depth=(16, 32, 24, 128))


class SepConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, kernel, stride, (kernel - 1) // 2, groups=in_channels,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels, momentum=FLAX_BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn1(self.conv1(x))


class CellA(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.sep_conv1 = SepConv(in_channels, out_channels, 7, stride)
        self.project = in_channels != out_channels
        if self.project:
            self.conv1 = nn.Conv2d(in_channels, out_channels, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y2 = F.max_pool2d(x, 3, self.stride, padding=1)  # pads with -inf, as the JAX cell
        if self.project:
            y2 = self.bn1(self.conv1(y2))
        return F.relu(self.sep_conv1(x) + y2)


class PNASNet(ClassifierNet):
    def __init__(self, num_classes: int = 10, num_cells: int = 6, num_planes: int = 44):
        super().__init__()
        p = num_planes
        self.conv1 = nn.Conv2d(3, p, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(p)
        self.layer1 = nn.Sequential(*(CellA(p, p) for _ in range(num_cells)))
        self.layer2 = CellA(p, 2 * p, 2)
        self.layer3 = nn.Sequential(*(CellA(2 * p, 2 * p) for _ in range(num_cells)))
        self.layer4 = CellA(2 * p, 4 * p, 2)
        self.layer5 = nn.Sequential(*(CellA(4 * p, 4 * p) for _ in range(num_cells)))
        self.linear = nn.Linear(4 * p, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer5(self.layer4(self.layer3(self.layer2(self.layer1(x)))))
        return self.linear(global_mean(x))


def gen_relative_position_index(window_size: Tuple[int, int]) -> np.ndarray:
    """The ``[A + 1, A + 1]`` index into the relative-position-bias table (A = Wh * Ww patches,
    plus the class token's row and column)."""
    wh, ww = window_size
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))  # [2, Wh, Ww]
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)  # [A, A, 2]
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    area = wh * ww
    index = np.zeros((area + 1, area + 1), np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_rel - 3
    index[0:, 0] = num_rel - 2
    index[0, 0] = num_rel - 1
    return index


class BEiTAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window_size: Tuple[int, int]):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        wh, ww = window_size
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * wh - 1) * (2 * ww - 1) + 3, heads))
        self.register_buffer("relative_position_index",
                             torch.as_tensor(gen_relative_position_index(window_size)).reshape(-1), persistent=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        hd = self.dim // self.heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])  # k has no bias
        q, k, v = (self.qkv(x) + bias).reshape(b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        rel = self.relative_position_bias_table[self.relative_position_index].reshape(n, n, self.heads)
        attn = torch.softmax(attn + rel.permute(2, 0, 1)[None], dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, self.dim))


class BEiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window_size: Tuple[int, int], mlp_ratio: float = 4.0,
                 init_scale: float = 0.1):
        super().__init__()
        self.init_scale = init_scale
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_scale))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_scale))
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = BEiTAttention(dim, heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class BEiT(ClassifierNet):
    """The BEiT fine-tune architecture at ``image_size`` (the bias tables' window is its patch grid)."""

    def __init__(self, num_classes: int = 1000, image_size=(224, 224), patch_size: int = 16, dim: int = 768,
                 depth: int = 12, heads: int = 12):
        super().__init__()
        window = (image_size[0] // patch_size, image_size[1] // patch_size)
        self.patch_embed = PatchEmbed(patch_size, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.blocks = nn.Sequential(*(BEiTBlock(dim, heads, window) for _ in range(depth)))
        self.fc_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, num_classes)

    def reset_extra(self, generator: torch.Generator) -> None:
        self.cls_token.zero_()
        for block in self.blocks:
            block.gamma_1.fill_(block.init_scale)
            block.gamma_2.fill_(block.init_scale)
            block.attn.q_bias.zero_()
            block.attn.v_bias.zero_()
            block.attn.relative_position_bias_table.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = self.blocks(torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1))
        return self.head(self.fc_norm(x[:, 1:].mean(dim=1)))
