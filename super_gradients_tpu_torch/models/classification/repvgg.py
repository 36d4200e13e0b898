"""RepVGG classification family, NCHW (counterpart of
``super_gradients_tpu/models/classification/repvgg.py``).

Attribute names are the original super-gradients ones (``stem``, ``stage1``..``stage4`` of
``RepVGGBlock``s with ``branch_3x3`` / ``branch_1x1`` / ``no_conv_branch``, or ``rbr_reparam``
in the deploy form, then ``linear``), which ``conversion/from_jax.py``'s ``REPVGG_RULES``
reach.

As in the JAX module: the stage widths ``min(64, 64 a)``, ``64 a``, ``128 a``, ``256 a``,
``512 b``; the stem has no identity branch; a block has one where its stride is 1 and its width
is kept; the first block of every stage has stride 2; the squeeze-excitation (``se_ratio``)
follows the activation of every block but the stem's. ``fused=True`` builds the deploy form
(the JAX ``fused="full"``); :func:`fuse_repvgg` turns a trained net into it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from super_gradients_tpu_torch.models.classification.common import ClassifierNet, global_mean
from super_gradients_tpu_torch.modules.blocks import RepVGGBlock


@dataclasses.dataclass(frozen=True)
class RepVGGCfg:
    num_classes: int = 1000
    blocks_per_stage: Tuple[int, ...] = (2, 4, 14, 1)
    width_a: float = 0.75  # stages 1-4 multiplier
    width_b: float = 2.5  # final stage multiplier
    se_ratio: float = 0.0  # > 0 adds a squeeze-excitation to every block but the stem (RepVGG-D2se)
    fused: bool = False


REPVGG_VARIANTS: Dict[str, RepVGGCfg] = {
    "repvgg_a0": RepVGGCfg(width_a=0.75, width_b=2.5),
    "repvgg_a1": RepVGGCfg(width_a=1.0, width_b=2.5),
    "repvgg_a2": RepVGGCfg(width_a=1.5, width_b=2.75),
    "repvgg_b0": RepVGGCfg(blocks_per_stage=(4, 6, 16, 1), width_a=1.0, width_b=2.5),
    "repvgg_b1": RepVGGCfg(blocks_per_stage=(4, 6, 16, 1), width_a=2.0, width_b=4.0),
    "repvgg_b2": RepVGGCfg(blocks_per_stage=(4, 6, 16, 1), width_a=2.5, width_b=5.0),
    "repvgg_b3": RepVGGCfg(blocks_per_stage=(4, 6, 16, 1), width_a=3.0, width_b=5.0),
    "repvgg_d2se": RepVGGCfg(blocks_per_stage=(8, 14, 24, 1), width_a=2.5, width_b=5.0, se_ratio=1 / 16),
}


class RepVGG(ClassifierNet):
    def __init__(self, cfg: RepVGGCfg):
        super().__init__()
        widths = [min(64, int(64 * cfg.width_a)), int(64 * cfg.width_a), int(128 * cfg.width_a),
                  int(256 * cfg.width_a), int(512 * cfg.width_b)]
        self.stem = RepVGGBlock(3, widths[0], stride=2, fused=cfg.fused)
        cin = widths[0]
        for si, (w, n) in enumerate(zip(widths[1:], cfg.blocks_per_stage)):
            blocks = []
            for bi in range(n):
                stride = 2 if bi == 0 else 1
                blocks.append(RepVGGBlock(cin, w, stride=stride, use_residual=stride == 1 and cin == w,
                                          fused=cfg.fused, se_ratio=cfg.se_ratio or None))
                cin = w
            setattr(self, f"stage{si + 1}", nn.Sequential(*blocks))
        self.linear = nn.Linear(cin, cfg.num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for si in range(1, 5):
            x = getattr(self, f"stage{si}")(x)
        return self.linear(global_mean(x))


def fuse_repvgg(net: nn.Module) -> nn.Module:
    """Re-parameterize every RepVGG block of ``net`` in place (eval-mode BN statistics): the
    reference's ``fuse_repvgg_blocks_residual_branches``."""
    for module in net.modules():
        if isinstance(module, RepVGGBlock):
            module.fuse_()
    return net
