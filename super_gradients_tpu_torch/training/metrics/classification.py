"""Classification metrics (counterpart of ``super_gradients_tpu/training/metrics/classification.py``).

They update on the outputs' device and keep their counts there, so a validation pass
syncs with the host only in ``compute``. Targets are int labels ``[B]`` or one-hot rows
(``targets.dim() == outputs.dim()``), taken by their argmax.
"""

from __future__ import annotations

from typing import Dict

import torch

from super_gradients_tpu_torch.common.registry import register_metric
from super_gradients_tpu_torch.training.metrics.base import Metric


def _labels(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return targets.argmax(dim=-1) if targets.dim() == outputs.dim() else targets


class _CountMetric(Metric):
    def init(self):
        return {"correct": 0, "total": 0}

    def compute(self, state) -> Dict[str, float]:
        total = float(state["total"])
        return {self.name: float(state["correct"]) / total if total else 0.0}


@register_metric("Accuracy")
class Accuracy(_CountMetric):
    """Top-1 accuracy; the prediction is the first largest logit."""

    name = "Accuracy"

    def update(self, state, outputs, targets):
        preds = outputs.argmax(dim=-1)
        correct = (preds == _labels(outputs, targets).to(preds.device)).sum()
        return {"correct": state["correct"] + correct, "total": state["total"] + preds.numel()}


@register_metric("Top5")
class Top5(_CountMetric):
    """Top-5 accuracy. The five come from a stable descending sort: equal logits rank by
    the lowest class index, as the JAX ``jnp.argsort(-outputs)`` ranks them (``torch.topk``
    promises no order among equal values)."""

    name = "Top5"

    def update(self, state, outputs, targets):
        labels = _labels(outputs, targets).to(outputs.device)
        k = min(5, outputs.shape[-1])
        topk = torch.sort(outputs, dim=-1, descending=True, stable=True).indices[..., :k]
        correct = (topk == labels[..., None]).any(dim=-1).sum()
        return {"correct": state["correct"] + correct, "total": state["total"] + labels.numel()}


@register_metric("ToyTestClassificationMetric")
class ToyTestClassificationMetric(Metric):
    """A constant metric for tests."""

    name = "ToyTestClassificationMetric"

    def init(self):
        return {}

    def update(self, state, outputs, targets):
        return state

    def compute(self, state):
        return {self.name: 0.0}
