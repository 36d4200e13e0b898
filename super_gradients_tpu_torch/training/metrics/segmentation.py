"""Segmentation metrics (counterpart of ``super_gradients_tpu/training/metrics/segmentation.py``).

Each keeps a ``[C_true, C_pred]`` confusion matrix on the outputs' device and reads it
once, in ``compute``. The JAX package builds the matrix as a float32 one-hot matmul, which
stops counting exactly once a cell passes 2**24 pixels; here each batch's pixels are
counted into int64 cells with ``scatter_add_`` (``bincount`` would read its size back to
the host): equal to JAX's below 2**24, exact above it. A pixel whose target is
``ignore_index`` or ``>= num_classes``, or whose prediction is ``>= num_classes`` (a metric of
fewer classes than the model's, as JAX's one-hot of such a prediction is all zeros), is not
counted. IoU and Dice average over the classes present in the targets.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from super_gradients_tpu_torch.common.registry import register_metric
from super_gradients_tpu_torch.training.metrics.base import Metric


def confusion_matrix(preds: torch.Tensor, targets: torch.Tensor, num_classes: int, ignore_index: int) -> torch.Tensor:
    """int64 ``[C, C]`` counts of (target, prediction) pairs over the valid pixels."""
    targets = targets.to(preds.device).long()
    valid = (targets != ignore_index) & (targets >= 0) & (targets < num_classes) & (preds < num_classes)
    # invalid pixels go to one bin past the matrix, dropped below
    cells = torch.where(valid, targets * num_classes + preds.long(), num_classes * num_classes).reshape(-1)
    counts = torch.zeros(num_classes * num_classes + 1, dtype=torch.int64, device=preds.device)
    counts.scatter_add_(0, cells, torch.ones_like(cells))
    return counts[:-1].reshape(num_classes, num_classes)


def _logits(outputs) -> torch.Tensor:
    return outputs[0] if isinstance(outputs, (tuple, list)) else outputs


class _ConfusionMatrixMetric(Metric):
    def __init__(self, num_classes: int = 19, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index

    def init(self):
        return None  # the first update makes the matrix on the outputs' device

    def predictions(self, logits: torch.Tensor) -> torch.Tensor:
        return logits.argmax(dim=1)

    def update(self, state, outputs, targets):
        cm = confusion_matrix(self.predictions(_logits(outputs)), targets, self.num_classes, self.ignore_index)
        return cm if state is None else state + cm

    def reduce_across_processes(self, state):
        if state is None:  # no update on this rank: its matrix is all zeros
            state = torch.zeros((self.num_classes, self.num_classes), dtype=torch.int64)
        return super().reduce_across_processes(state)

    def _matrix(self, state) -> np.ndarray:
        if state is None:
            return np.zeros((self.num_classes, self.num_classes), dtype=np.float64)
        return state.cpu().numpy().astype(np.float64)


def _mean_over_present(values: np.ndarray, cm: np.ndarray) -> float:
    present = cm.sum(1) > 0
    return float(values[present].mean()) if present.any() else 0.0


@register_metric("IoU")
class IoU(_ConfusionMatrixMetric):
    name = "IoU"

    def compute(self, state) -> Dict[str, float]:
        cm = self._matrix(state)
        tp = np.diag(cm)
        denom = cm.sum(0) + cm.sum(1) - tp
        return {self.name: _mean_over_present(np.where(denom > 0, tp / np.maximum(denom, 1e-9), 0.0), cm)}


@register_metric("Dice")
class Dice(_ConfusionMatrixMetric):
    name = "Dice"

    def compute(self, state) -> Dict[str, float]:
        cm = self._matrix(state)
        tp = np.diag(cm)
        denom = cm.sum(0) + cm.sum(1)
        return {self.name: _mean_over_present(np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-9), 0.0), cm)}


class _BinaryPredictions:
    """A one-channel output is foreground where its sigmoid exceeds 0.5; more channels
    take the argmax."""

    def predictions(self, logits: torch.Tensor) -> torch.Tensor:
        if logits.shape[1] == 1:
            return (torch.sigmoid(logits[:, 0]) > 0.5).long()
        return logits.argmax(dim=1)


@register_metric("BinaryIOU")
@register_metric("BinaryIoU")
class BinaryIoU(_BinaryPredictions, IoU):
    name = "BinaryIoU"

    def __init__(self, ignore_index: int = 255, **kw):
        super().__init__(num_classes=2, ignore_index=ignore_index)


@register_metric("BinaryDice")
class BinaryDice(_BinaryPredictions, Dice):
    name = "BinaryDice"

    def __init__(self, ignore_index: int = 255, **kw):
        super().__init__(num_classes=2, ignore_index=ignore_index)


@register_metric("PixelAccuracy")
class PixelAccuracy(_ConfusionMatrixMetric):
    name = "PixelAccuracy"

    def compute(self, state) -> Dict[str, float]:
        cm = self._matrix(state)
        total = cm.sum()
        return {self.name: float(np.diag(cm).sum() / total) if total else 0.0}
