"""Image inputs for predict (counterpart of ``super_gradients_tpu/inference/media.py``).

Accepts an HWC or 2-D array, an NHWC array, a PIL image, an image file path, a folder
(its files with an image extension, in sorted order) or a list / tuple of these, and
returns RGB uint8 HWC arrays. PIL is imported where a file or a PIL image is read.
Video paths go to ``SgModel.predict_video`` (``inference/video.py``).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

_IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def load_image(image) -> np.ndarray:
    """One image as RGB uint8 HWC: a 2-D array is repeated over three channels, another
    dtype clipped to [0, 255]; a path or a PIL image through PIL's ``convert("RGB")``."""
    if isinstance(image, np.ndarray):
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        if image.ndim != 3:
            raise ValueError(f"expected an HWC image, got shape {image.shape}")
        if image.dtype != np.uint8:
            image = np.clip(image, 0, 255).astype(np.uint8)
        return image
    if isinstance(image, str):
        from PIL import Image

        with Image.open(image) as im:
            return np.asarray(im.convert("RGB"))
    try:
        from PIL import Image

        if isinstance(image, Image.Image):
            return np.asarray(image.convert("RGB"))
    except ImportError:
        pass
    raise TypeError(f"Unsupported image source type: {type(image)}")


def images_to_list(images) -> List[np.ndarray]:
    if isinstance(images, np.ndarray) and images.ndim == 4:
        return [load_image(im) for im in images]
    if isinstance(images, (list, tuple)):
        return [load_image(im) for im in images]
    if isinstance(images, str) and os.path.isdir(images):
        files = sorted(os.path.join(images, f) for f in os.listdir(images) if f.lower().endswith(_IMG_EXTENSIONS))
        return [load_image(f) for f in files]
    return [load_image(images)]
