"""Image inputs for predict, numpy only (counterpart of
``super_gradients_tpu/inference/media.py``).

Accepts an HWC array, an NHWC array, or a list/tuple of HWC arrays, and returns
RGB uint8 HWC arrays. Paths, directories, PIL images and video need PIL or cv2,
which the port does not depend on yet; they raise :class:`TypeError`.
"""

from __future__ import annotations

from typing import List

import numpy as np


def load_image(image) -> np.ndarray:
    if not isinstance(image, np.ndarray):
        raise TypeError(
            f"super_gradients_tpu_torch predicts on numpy images only (HWC uint8 RGB); got {type(image).__name__}. "
            "Loading files, PIL images and video is not ported yet."
        )
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    if image.ndim != 3:
        raise ValueError(f"expected an HWC image, got shape {image.shape}")
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    return image


def images_to_list(images) -> List[np.ndarray]:
    if isinstance(images, np.ndarray) and images.ndim == 4:
        return [load_image(im) for im in images]
    if isinstance(images, (list, tuple)):
        return [load_image(im) for im in images]
    return [load_image(images)]
