"""Vision Transformer Base / Large / Huge, NCHW input (counterpart of
``super_gradients_tpu/models/classification/vit.py``).

Attribute names are the original super-gradients ones (``patch_embedding.proj``, ``cls_token``,
``pos_embedding``, ``transformer.blocks.{i}`` with ``norm1``, ``attn.to_qkv``, ``attn.proj``,
``norm2``, ``mlp.fc1``, ``mlp.fc2``, then ``pre_head_norm`` and ``head``), which
``conversion/from_jax.py``'s ``VIT_RULES`` reach.

As in the JAX module: the patch embedding is a ``patch``-strided conv padded as XLA's ``SAME``;
the class token starts at zero and the position embedding from ``N(0, 0.02)``, one row per patch
of the size the net is built for plus the class token; pre-LN blocks with flax's LayerNorm eps
1e-6 and the tanh GELU; the attention keeps the fused ``to_qkv`` and JAX's order, the product
``q k^T``, then the scale ``dh^-0.5``, then the softmax (``scaled_dot_product_attention`` scales
q first, so it is not called); the head reads the class token after ``pre_head_norm``. The MLP's
dropout (:class:`SeededDropout`) follows the GELU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_gradients_tpu_torch.models.classification.common import ClassifierNet, SameConv2d
from super_gradients_tpu_torch.models.segmentation.stdc import SeededDropout

LN_EPS = 1e-6  # flax's LayerNorm default


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = SameConv2d(3, dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)  # [B, N, D], patches in row-major order


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        dh = c // self.heads
        q, k, v = self.to_qkv(x).reshape(b, n, 3, self.heads, dh).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * dh ** -0.5, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dropout: float):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dropout = SeededDropout(dropout)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.dropout(F.gelu(self.fc1(x), approximate="tanh")))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, dropout: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(ClassifierNet):
    def __init__(self, num_classes: int = 1000, image_size=(224, 224), patch_size: int = 16, dim: int = 768,
                 depth: int = 12, heads: int = 12, mlp_ratio: float = 4.0, dropout: float = 0.0):
        super().__init__()
        n = -(-image_size[0] // patch_size) * -(-image_size[1] // patch_size)  # SAME: ceil on each side
        self.patch_embedding = PatchEmbed(patch_size, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n + 1, dim))
        self.transformer = nn.Module()
        self.transformer.blocks = nn.Sequential(*(TransformerBlock(dim, heads, mlp_ratio, dropout)
                                                  for _ in range(depth)))
        self.pre_head_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, num_classes)

    def reset_extra(self, generator: torch.Generator) -> None:
        self.cls_token.zero_()
        self.pos_embedding.copy_(torch.randn(self.pos_embedding.shape, generator=generator) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(x)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embedding
        x = self.pre_head_norm(self.transformer.blocks(x))
        return self.head(x[:, 0])
