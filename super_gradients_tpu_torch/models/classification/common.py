"""What the classification zoo's networks share: the seeded random init, the global mean and
the XLA ``SAME`` conv.

Each family's network subclasses :class:`ClassifierNet`, whose ``reset_parameters`` draws
He-normal conv weights, LeCun-normal ``Linear`` weights (flax's ``Dense`` default) and zero
biases from the generator, resets BatchNorm and LayerNorm to unit scale and zero shift with
(0, 1) running statistics, then lets the family set its own tensors (:meth:`reset_extra`: a
ViT's position embedding, BEiT's LayerScale).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from super_gradients_tpu_torch.modules.blocks import same_pad


class ClassifierNet(nn.Module):
    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "ClassifierNet":
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                gain = 2.0 if isinstance(module, nn.Conv2d) else 1.0
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * math.sqrt(gain / fan_in))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (nn.BatchNorm2d, nn.LayerNorm)):
                module.reset_parameters()
        self.reset_extra(generator)
        return self

    def reset_extra(self, generator: torch.Generator) -> None:
        """The family's own tensors beyond convs, ``Linear`` layers and norms."""


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W] -> [B, C]``: the mean over H and W (the JAX heads' ``jnp.mean(x, (1, 2))``)."""
    return x.mean(dim=(2, 3))


class SameConv2d(nn.Conv2d):
    """A conv padded as XLA's ``SAME`` (asymmetric where the overhang is odd: ``(0, 1)`` for a
    stride-2 3x3 on an even size), flax's default padding and EfficientNet's ``padding="same"``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1, groups: int = 1,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel, stride, 0, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(same_pad(x, self.kernel_size[0], self.stride[0]))
