"""Segmentation transforms (counterpart of ``super_gradients_tpu/training/transforms/segmentation.py``).

Host-side augmentation on a :class:`SegSample`: ``image`` float32 ``[H, W, 3]`` (0..255 until
``SegStandardize``) and ``mask`` int32 ``[H, W]`` with ``ignore_index`` (255) for void pixels.
Each transform makes the JAX package's PIL calls, in its order (bilinear images, nearest
masks; rotate and pad fill the image with ``fill_image`` and the mask with ``fill_mask``), so
samples come out byte-equal to the JAX transforms'.

Every random decision draws from the ``random.Random`` passed in as ``rng``, in the order in
which the JAX transform draws from the global ``random``: ``SegColorJitter`` shuffles its
operations first and draws each factor as its operation runs, in the shuffled order. A
transform is ``t(sample, rng) -> sample``; :class:`SegCompose` takes a sample or an
``(image, mask)`` pair and returns the same kind. The classes are listed under their names in
``SEGMENTATION_TRANSFORMS``. PIL is imported at the call.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, Optional, Sequence, Tuple, Type, Union

import numpy as np


@dataclasses.dataclass
class SegSample:
    image: np.ndarray  # [H, W, 3] float32
    mask: np.ndarray  # [H, W] int32


SEGMENTATION_TRANSFORMS: Dict[str, Type] = {}


def _register(cls):
    SEGMENTATION_TRANSFORMS[cls.__name__] = cls
    return cls


def _pil_pair(sample: SegSample):
    from PIL import Image

    img = Image.fromarray(np.clip(sample.image, 0, 255).astype(np.uint8))
    msk = Image.fromarray(sample.mask.astype(np.uint8), mode="L")
    return img, msk


def _from_pil(img, msk) -> SegSample:
    return SegSample(np.asarray(img, np.float32), np.asarray(msk, np.int32))


def _resized(sample: SegSample, w: int, h: int) -> SegSample:
    from PIL import Image

    img, msk = _pil_pair(sample)
    return _from_pil(img.resize((w, h), Image.BILINEAR), msk.resize((w, h), Image.NEAREST))


@_register
class SegResize:
    """Resize to (h, w)."""

    def __init__(self, h: int = 512, w: int = 512):
        self.h, self.w = h, w

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        return _resized(sample, self.w, self.h)


@_register
class SegRandomFlip:
    """Horizontal flip of image and mask with probability ``prob``."""

    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        if rng.random() < self.prob:
            return SegSample(np.ascontiguousarray(sample.image[:, ::-1]), np.ascontiguousarray(sample.mask[:, ::-1]))
        return sample


def _rescale(sample: SegSample, scale: float) -> SegSample:
    h, w = sample.mask.shape
    return _resized(sample, max(1, int(round(w * scale))), max(1, int(round(h * scale))))


@_register
class SegRescale:
    """Rescale by ``scale_factor``, or so that the short side is ``short_size`` or the long side
    ``long_size``; the identity without any of them."""

    def __init__(self, scale_factor: Optional[float] = None, short_size: Optional[int] = None,
                 long_size: Optional[int] = None):
        self.scale_factor, self.short_size, self.long_size = scale_factor, short_size, long_size

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        h, w = sample.mask.shape
        if self.scale_factor is not None:
            scale = self.scale_factor
        elif self.short_size is not None:
            scale = self.short_size / min(h, w)
        elif self.long_size is not None:
            scale = self.long_size / max(h, w)
        else:
            return sample
        return _rescale(sample, scale)


@_register
class SegRandomRescale:
    """Rescale by a factor drawn uniformly from ``scales = (lo, hi)``; one number ``s`` means
    ``(1 / s, s)``."""

    def __init__(self, scales: Union[float, Tuple[float, float]] = (0.5, 2.0)):
        if isinstance(scales, (int, float)):
            scales = (1.0 / scales, scales) if scales > 1 else (scales, 1.0 / scales)
        if scales[0] > scales[1]:
            scales = (scales[1], scales[0])
        if scales[0] <= 0:
            raise ValueError(f"SegRandomRescale scales must be positive, got {scales}")
        self.scales = tuple(scales)

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        return _rescale(sample, rng.uniform(*self.scales))


@_register
class SegRandomRotate:
    """Rotation by a uniform angle in ``[min_deg, max_deg]``; exposed pixels take ``fill_image``
    and ``fill_mask`` (void)."""

    def __init__(self, min_deg: float = -10.0, max_deg: float = 10.0,
                 fill_mask: int = 255, fill_image: Union[int, Tuple[int, int, int]] = 0):
        self.min_deg, self.max_deg = min_deg, max_deg
        self.fill_mask = fill_mask
        self.fill_image = tuple(fill_image) if isinstance(fill_image, (tuple, list)) else (fill_image,) * 3

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        from PIL import Image

        deg = rng.uniform(self.min_deg, self.max_deg)
        img, msk = _pil_pair(sample)
        img = img.rotate(deg, resample=Image.BILINEAR, fillcolor=self.fill_image)
        msk = msk.rotate(deg, resample=Image.NEAREST, fillcolor=self.fill_mask)
        return _from_pil(img, msk)


@_register
class SegCropImageAndMask:
    """Crop to ``crop_size`` (at most the sample's size), at a random place or the centre."""

    def __init__(self, crop_size: Union[int, Tuple[int, int]] = 512, mode: str = "random"):
        if isinstance(crop_size, int):
            crop_size = (crop_size, crop_size)
        if mode not in ("random", "center"):
            raise ValueError(f"SegCropImageAndMask mode must be random|center, got {mode}")
        self.crop_h, self.crop_w = crop_size
        self.mode = mode

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        h, w = sample.mask.shape
        ch, cw = min(self.crop_h, h), min(self.crop_w, w)
        if self.mode == "random":
            y0 = rng.randint(0, h - ch)
            x0 = rng.randint(0, w - cw)
        else:
            y0, x0 = (h - ch) // 2, (w - cw) // 2
        return SegSample(sample.image[y0:y0 + ch, x0:x0 + cw], sample.mask[y0:y0 + ch, x0:x0 + cw])


@_register
class SegRandomGaussianBlur:
    """Gaussian blur of the image alone with probability ``prob``, its radius drawn uniformly
    from ``sigma`` (``kernel_size`` is accepted and unused, as in JAX)."""

    def __init__(self, prob: float = 0.5, kernel_size: int = 3, sigma: Tuple[float, float] = (0.1, 2.0)):
        self.prob = prob
        self.sigma = sigma

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        if rng.random() >= self.prob:
            return sample
        from PIL import Image, ImageFilter

        img = Image.fromarray(np.clip(sample.image, 0, 255).astype(np.uint8))
        img = img.filter(ImageFilter.GaussianBlur(radius=rng.uniform(*self.sigma)))
        return SegSample(np.asarray(img, np.float32), sample.mask)


@_register
class SegPadShortToCropSize:
    """Pad the sides shorter than ``crop_size`` up to it, centred (the odd pixel at the bottom
    or right); the image with ``fill_image``, the mask with ``fill_mask``."""

    def __init__(self, crop_size: Union[int, Tuple[int, int]] = 512,
                 fill_mask: int = 255, fill_image: Union[int, Tuple[int, int, int]] = 0):
        if isinstance(crop_size, int):
            crop_size = (crop_size, crop_size)
        self.crop_h, self.crop_w = crop_size
        self.fill_mask = fill_mask
        self.fill_image = fill_image if isinstance(fill_image, (int, float)) else tuple(fill_image)

    def _pad(self, sample: SegSample, pad_h: int, pad_w: int) -> SegSample:
        t, l = pad_h // 2, pad_w // 2
        b, r = pad_h - t, pad_w - l
        if isinstance(self.fill_image, (int, float)):
            img = np.pad(sample.image, ((t, b), (l, r), (0, 0)), constant_values=float(self.fill_image))
        else:  # a colour: one constant a channel
            img = np.stack([np.pad(sample.image[..., ci], ((t, b), (l, r)), constant_values=v)
                            for ci, v in enumerate(self.fill_image)], axis=-1)
        msk = np.pad(sample.mask, ((t, b), (l, r)), constant_values=self.fill_mask)
        return SegSample(img, msk)

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        h, w = sample.mask.shape
        pad_h, pad_w = max(0, self.crop_h - h), max(0, self.crop_w - w)
        if pad_h == 0 and pad_w == 0:
            return sample
        return self._pad(sample, pad_h, pad_w)


@_register
class SegPadToDivisible:
    """Pad the bottom and right so that H and W divide ``divisible_value``: the image with 0,
    the mask with ``fill_mask`` (``fill_image`` is accepted and unused, as in JAX)."""

    def __init__(self, divisible_value: int = 32, fill_mask: int = 255,
                 fill_image: Union[int, Tuple[int, int, int]] = 0):
        self.div = divisible_value
        self.fill_mask = fill_mask

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        h, w = sample.mask.shape
        pad_h = (self.div - h % self.div) % self.div
        pad_w = (self.div - w % self.div) % self.div
        if pad_h == 0 and pad_w == 0:
            return sample
        img = np.pad(sample.image, ((0, pad_h), (0, pad_w), (0, 0)), constant_values=0.0)
        msk = np.pad(sample.mask, ((0, pad_h), (0, pad_w)), constant_values=self.fill_mask)
        return SegSample(img, msk)


@_register
class SegColorJitter:
    """Brightness, contrast, saturation and hue jitter of the image, in a shuffled order: each
    factor uniform in ``max(0, 1 - v) .. 1 + v``, the hue shift in ``-v .. v`` of the circle."""

    def __init__(self, brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0):
        self.brightness, self.contrast, self.saturation, self.hue = brightness, contrast, saturation, hue

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        from PIL import Image, ImageEnhance

        def enhance(kind, v):
            return lambda im: getattr(ImageEnhance, kind)(im).enhance(rng.uniform(max(0, 1 - v), 1 + v))

        def hue(im):
            h, s, v = im.convert("HSV").split()
            shift = int(rng.uniform(-self.hue, self.hue) * 255)
            h = h.point(lambda p: (p + shift) % 256)
            return Image.merge("HSV", (h, s, v)).convert("RGB")

        ops = [enhance(kind, v) for kind, v in (("Brightness", self.brightness), ("Contrast", self.contrast),
                                                ("Color", self.saturation)) if v]
        if self.hue:
            ops.append(hue)
        rng.shuffle(ops)
        img = Image.fromarray(np.clip(sample.image, 0, 255).astype(np.uint8))
        for op in ops:
            img = op(img)
        return SegSample(np.asarray(img, np.float32), sample.mask)


@_register
class SegStandardize:
    """The image divided by ``max_value`` (uint8 range to [0, 1])."""

    def __init__(self, max_value: float = 255.0):
        self.max_value = max_value

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        return SegSample(sample.image / self.max_value, sample.mask)


@_register
class SegNormalize:
    """Channel-wise ``(image - mean) / std`` in float32."""

    def __init__(self, mean: Sequence[float] = (0.485, 0.456, 0.406),
                 std: Sequence[float] = (0.229, 0.224, 0.225)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: SegSample, rng: random.Random) -> SegSample:
        return SegSample((sample.image - self.mean) / self.std, sample.mask)


class SegCompose:
    """A chain of segmentation transforms over a :class:`SegSample` or an ``(image, mask)``
    pair (returned as a pair); the draws come from ``rng`` (a fresh unseeded generator when
    none is given)."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample_or_image, mask: Optional[np.ndarray] = None, rng: Optional[random.Random] = None):
        rng = random.Random() if rng is None else rng
        pair_in = not isinstance(sample_or_image, SegSample)
        sample = (SegSample(np.asarray(sample_or_image, np.float32), np.asarray(mask, np.int32)) if pair_in
                  else sample_or_image)
        for t in self.transforms:
            sample = t(sample, rng)
        return (sample.image, sample.mask) if pair_in else sample
