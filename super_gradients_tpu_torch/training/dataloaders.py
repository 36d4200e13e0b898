"""Synthetic detection data (counterpart of ``RandomDetectionDataset`` in
``super_gradients_tpu/training/dataloaders.py``).

Batches come from ``torch.utils.data.DataLoader`` (``pin_memory=True`` for a
GPU), whose default collate stacks the numpy samples into tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class RandomDetectionDataset:
    """Images ``[3, H, W]`` float32 in [0, 1) and padded ``[max_boxes, 5]`` targets
    (cls, x1, y1, x2, y2; ``-1`` rows pad). Sample ``i`` is drawn from
    ``np.random.RandomState(i)``: the JAX dataset's sample ``i``, its image NCHW."""

    def __init__(self, num_samples: int = 32, image_size: Tuple[int, int] = (320, 320), num_classes: int = 80,
                 max_boxes: int = 20):
        self.num_samples = num_samples
        self.image_size = tuple(image_size)
        self.num_classes = num_classes
        self.max_boxes = max_boxes

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        h, w = self.image_size
        img = rng.rand(h, w, 3).astype(np.float32)
        n = rng.randint(1, max(2, self.max_boxes // 2))
        cxy = rng.rand(n, 2) * [w * 0.8, h * 0.8] + [w * 0.1, h * 0.1]
        wh = rng.rand(n, 2) * [w * 0.3, h * 0.3] + 8
        x1y1 = np.maximum(cxy - wh / 2, 0)
        x2y2 = np.minimum(cxy + wh / 2, [w, h])
        cls = rng.randint(0, self.num_classes, size=(n, 1)).astype(np.float32)
        target = np.full((self.max_boxes, 5), -1.0, dtype=np.float32)
        target[:n] = np.concatenate([cls, x1y1, x2y2], axis=1)
        return np.ascontiguousarray(img.transpose(2, 0, 1)), target
