"""Classification augmentations: RandAugment, RandomErase, batch mixup and cutmix
(counterpart of ``super_gradients_tpu/training/transforms/classification.py``).

Host-side numpy / PIL (PIL imported at the call). ``RandAugment`` and ``RandomErase`` draw
from the global ``random`` (and ``RandomErase``'s fill from ``np.random``), ``mixup_batch``
and ``cutmix_batch`` from ``rng`` (``np.random`` by default), as the JAX transforms do: for
the same seeds they give the same images and soft labels.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np


def _pil(img: np.ndarray):
    from PIL import Image

    return Image.fromarray(img.astype(np.uint8))


def _rand_level(magnitude: int, maxval: float) -> float:
    return magnitude / 30.0 * maxval


class RandAugment:
    """N random ops at magnitude M (ref auto_augment.py rand_augment_transform)."""

    def __init__(self, num_ops: int = 2, magnitude: int = 9):
        self.num_ops = num_ops
        self.magnitude = magnitude

    # each op: name -> fn(PIL, magnitude) -> PIL
    def _ops(self):
        from PIL import Image, ImageEnhance, ImageOps

        m = self.magnitude

        def shear_x(im):
            v = _rand_level(m, 0.3) * random.choice([-1, 1])
            return im.transform(im.size, Image.AFFINE, (1, v, 0, 0, 1, 0))

        def shear_y(im):
            v = _rand_level(m, 0.3) * random.choice([-1, 1])
            return im.transform(im.size, Image.AFFINE, (1, 0, 0, v, 1, 0))

        def translate_x(im):
            v = int(_rand_level(m, 0.45) * im.size[0]) * random.choice([-1, 1])
            return im.transform(im.size, Image.AFFINE, (1, 0, v, 0, 1, 0))

        def translate_y(im):
            v = int(_rand_level(m, 0.45) * im.size[1]) * random.choice([-1, 1])
            return im.transform(im.size, Image.AFFINE, (1, 0, 0, 0, 1, v))

        def rotate(im):
            return im.rotate(_rand_level(m, 30) * random.choice([-1, 1]))

        def color(im):
            return ImageEnhance.Color(im).enhance(1 + _rand_level(m, 0.9) * random.choice([-1, 1]))

        def contrast(im):
            return ImageEnhance.Contrast(im).enhance(1 + _rand_level(m, 0.9) * random.choice([-1, 1]))

        def brightness(im):
            return ImageEnhance.Brightness(im).enhance(1 + _rand_level(m, 0.9) * random.choice([-1, 1]))

        def sharpness(im):
            return ImageEnhance.Sharpness(im).enhance(1 + _rand_level(m, 0.9) * random.choice([-1, 1]))

        def posterize(im):
            return ImageOps.posterize(im, max(1, 8 - int(_rand_level(m, 4))))

        def solarize(im):
            return ImageOps.solarize(im, int(256 - _rand_level(m, 110)))

        def autocontrast(im):
            return ImageOps.autocontrast(im)

        def equalize(im):
            return ImageOps.equalize(im)

        def invert(im):
            return ImageOps.invert(im)

        return [shear_x, shear_y, translate_x, translate_y, rotate, color, contrast,
                brightness, sharpness, posterize, solarize, autocontrast, equalize, invert]

    def __call__(self, image: np.ndarray) -> np.ndarray:
        im = _pil(image)
        for op in random.sample(self._ops(), self.num_ops):
            im = op(im)
        return np.asarray(im)


class RandomErase:
    """Random rectangle erase (ref data_augmentation.py RandomErase)."""

    def __init__(self, probability: float = 0.5, area_range: Tuple[float, float] = (0.02, 0.33), value: str = "random"):
        self.probability = probability
        self.area_range = area_range
        self.value = value

    def __call__(self, image: np.ndarray) -> np.ndarray:
        if random.random() >= self.probability:
            return image
        h, w = image.shape[:2]
        area = h * w * random.uniform(*self.area_range)
        aspect = random.uniform(0.3, 3.3)
        eh = int(round(np.sqrt(area * aspect)))
        ew = int(round(np.sqrt(area / aspect)))
        if eh >= h or ew >= w:
            return image
        y = random.randint(0, h - eh)
        x = random.randint(0, w - ew)
        out = image.copy()
        if self.value == "random":
            out[y : y + eh, x : x + ew] = np.random.randint(0, 255, (eh, ew) + image.shape[2:], dtype=np.uint8)
        else:
            out[y : y + eh, x : x + ew] = 0
        return out


def mixup_batch(images: np.ndarray, labels: np.ndarray, num_classes: int, alpha: float = 0.2, rng=None):
    """Batch mixup → (mixed images, soft labels) (ref datasets/mixup.py)."""
    rng = rng or np.random
    lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    perm = rng.permutation(len(images))
    mixed = lam * images + (1 - lam) * images[perm]
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    soft = lam * onehot + (1 - lam) * onehot[perm]
    return mixed.astype(images.dtype), soft


def cutmix_batch(images: np.ndarray, labels: np.ndarray, num_classes: int, alpha: float = 1.0, rng=None):
    """Batch cutmix → (mixed images, soft labels)."""
    rng = rng or np.random
    lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    b, h, w = images.shape[:3]
    perm = rng.permutation(b)
    rh, rw = int(h * np.sqrt(1 - lam)), int(w * np.sqrt(1 - lam))
    cy, cx = rng.randint(h), rng.randint(w)
    y1, y2 = np.clip(cy - rh // 2, 0, h), np.clip(cy + rh // 2, 0, h)
    x1, x2 = np.clip(cx - rw // 2, 0, w), np.clip(cx + rw // 2, 0, w)
    out = images.copy()
    out[:, y1:y2, x1:x2] = images[perm][:, y1:y2, x1:x2]
    lam_adj = 1 - (y2 - y1) * (x2 - x1) / (h * w)
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    soft = lam_adj * onehot + (1 - lam_adj) * onehot[perm]
    return out, soft
