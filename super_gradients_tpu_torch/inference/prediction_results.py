"""Prediction result objects, data fields only (counterpart of
``super_gradients_tpu/inference/prediction_results.py``).

Drawing and saving need PIL or cv2, which the port does not depend on yet; they
raise :class:`NotImplementedError` with that reason.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

_NO_DRAWING = "drawing and saving predictions are not ported to super_gradients_tpu_torch yet (they need PIL or cv2)"


@dataclasses.dataclass
class DetectionPrediction:
    """Per-image detection result in original-image coordinates."""

    bboxes_xyxy: np.ndarray  # [N, 4]
    confidence: np.ndarray  # [N]
    labels: np.ndarray  # [N] int
    class_names: Optional[List[str]] = None
    image: Optional[np.ndarray] = None  # HWC RGB uint8

    def __len__(self):
        return len(self.confidence)

    def draw(self, *args, **kwargs):
        raise NotImplementedError(_NO_DRAWING)

    def save(self, *args, **kwargs):
        raise NotImplementedError(_NO_DRAWING)


class ImagesPredictions:
    """Container over per-image predictions."""

    def __init__(self, predictions: List):
        self._images_prediction_lst = predictions

    def __len__(self):
        return len(self._images_prediction_lst)

    def __getitem__(self, i):
        return self._images_prediction_lst[i]

    def __iter__(self):
        return iter(self._images_prediction_lst)

    def save(self, *args, **kwargs):
        raise NotImplementedError(_NO_DRAWING)
