"""Classification losses (counterpart of
``super_gradients_tpu/training/losses/classification_losses.py``).

Each loss is ``loss(outputs, targets) -> (loss, {name: loss})``. Targets are int labels
``[B]`` or one-hot / soft rows ``[B, C]``; an int label outside ``[0, C)`` is a row of
zeros, as ``jax.nn.one_hot`` makes it. Label smoothing is optax's ``smooth_labels``,
``onehot * (1 - eps) + eps / C``, written out: ``F.cross_entropy(label_smoothing=)``
smooths only int targets. Under a process group the means are over the global batch
(``parallel/collectives.py::global_mean``), so a final uneven batch stays exact;
``RSquaredLoss``, whose denominator is a variance about the batch's mean, refuses to run
across ranks.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from super_gradients_tpu_torch.common.registry import register_loss
from super_gradients_tpu_torch.parallel.collectives import global_mean, refuse_across_ranks


def _one_hot(targets: torch.Tensor, outputs: torch.Tensor) -> torch.Tensor:
    """Int labels ``[...]`` -> ``[..., C]`` in the outputs' dtype; one-hot / soft rows as they are."""
    num_classes = outputs.shape[-1]
    if targets.dim() == outputs.dim() - 1:
        classes = torch.arange(num_classes, device=targets.device)
        return (targets[..., None].long() == classes).to(outputs.dtype)
    return targets.to(outputs.dtype)


@register_loss("CrossEntropyLoss")
class CrossEntropyLoss:
    """Softmax cross entropy, mean over the batch; ``smooth_eps`` is the original
    super-gradients name of ``label_smoothing`` (it wins when both are given)."""

    def __init__(self, label_smoothing: float = 0.0, smooth_eps: float = None):
        self.label_smoothing = label_smoothing if smooth_eps is None else smooth_eps

    def __call__(self, outputs: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        onehot = _one_hot(targets, outputs)
        if self.label_smoothing:
            onehot = onehot * (1.0 - self.label_smoothing) + self.label_smoothing / outputs.shape[-1]
        loss = global_mean(-(onehot * F.log_softmax(outputs, dim=-1)).sum(dim=-1))
        return loss, {"CrossEntropyLoss": loss}


@register_loss("LabelSmoothingCrossEntropyLoss")
class LabelSmoothingCrossEntropyLoss(CrossEntropyLoss):
    def __init__(self, smooth_eps: float = 0.1, **kw):
        super().__init__(label_smoothing=smooth_eps)


@register_loss("FocalLoss")
class FocalLoss:
    """Binary focal loss over one-hot targets, summed over the classes, mean over the batch."""

    def __init__(self, alpha: float = 0.25, gamma: float = 2.0):
        self.alpha, self.gamma = alpha, gamma

    def __call__(self, outputs: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        onehot = _one_hot(targets, outputs)
        p = torch.sigmoid(outputs)
        # optax's sigmoid_binary_cross_entropy
        ce = -onehot * F.logsigmoid(outputs) - (1.0 - onehot) * F.logsigmoid(-outputs)
        p_t = p * onehot + (1 - p) * (1 - onehot)
        alpha_t = self.alpha * onehot + (1 - self.alpha) * (1 - onehot)
        loss = global_mean((alpha_t * (1 - p_t) ** self.gamma * ce).sum(dim=-1))
        return loss, {"FocalLoss": loss}


@register_loss("MSE")
class MSELoss:
    """Mean squared error, the targets reshaped to the outputs."""

    def __call__(self, outputs: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        loss = global_mean((outputs - targets.reshape(outputs.shape).to(outputs.dtype)) ** 2)
        return loss, {"MSE": loss}


@register_loss("RSquaredLoss")
class RSquaredLoss:
    """``1 - R^2`` as the JAX loss computes it: ``sum((t - o)^2) / (sum((t - mean t)^2) + 1e-9)``."""

    def __call__(self, outputs: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        refuse_across_ranks(type(self).__name__)
        outputs = outputs.reshape(targets.shape)
        targets = targets.to(outputs.dtype)
        ss_res = ((targets - outputs) ** 2).sum()
        ss_tot = ((targets - targets.mean()) ** 2).sum()
        loss = ss_res / (ss_tot + 1e-9)
        return loss, {"RSquaredLoss": loss}
