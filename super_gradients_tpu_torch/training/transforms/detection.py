"""Detection transforms (counterpart of ``super_gradients_tpu/training/transforms/detection.py``).

Host-side augmentation on numpy HWC images. Wherever cv2 imports (at the call, through
``inference/processing.py::cv2_module``), the image operations are the JAX package's
own cv2 calls, with its flags, border values and LUTs, so images come out byte-equal:

- resize: ``cv2.resize(INTER_LINEAR)``;
- affine warp: ``cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT, border_value)`` of the
  forward matrix;
- HSV: ``cv2.cvtColor`` to HSV, ``cv2.LUT`` on each channel, ``cv2.cvtColor`` back;
- mixup of uint8 images: ``cv2.addWeighted(a, .5, b, .5, 0)``.

Without cv2 each runs its numpy / torch stand-in, within a grey level or so of cv2:

- resize: ``inference/processing.py::resize_bilinear`` (``F.interpolate``, half-pixel
  centres, no antialias, rounded to uint8), within one grey level of ``INTER_LINEAR``;
- affine warp: :func:`warp_affine`, a bilinear sample of the source at
  ``M^-1 (x, y, 1)`` for every output pixel centre (``F.grid_sample``,
  ``align_corners=True``). Sampling ``image - border`` with zero padding and adding
  ``border`` back gives cv2's constant border exactly;
- HSV: cv2's uint8 conversions (H in [0, 180), the integer RGB->HSV of ``RGB2HSV_b`` in
  :func:`rgb_to_hsv_u8` and the float32 HSV->RGB of ``HSV2RGB_b`` in
  :func:`hsv_to_rgb_u8`) around the same LUTs;
- mixup: :func:`add_weighted_half`, ``addWeighted``'s rounding half to even.

Every random decision draws from the ``random.Random`` passed in as ``rng``, in the
order in which the JAX transform draws from the global ``random``, on either path: for
the same seed the boxes, labels and crowd flags are exactly equal. Transforms that need
extra images (mosaic, mixup) declare ``additional_samples_count`` and get them from the
dataset.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from super_gradients_tpu_torch.inference import processing


@dataclasses.dataclass
class DetectionSample:
    """One image with its boxes: ``image`` HWC uint8 or float, ``bboxes_xyxy`` [N, 4]
    float32, ``labels`` [N] int32, ``is_crowd`` [N] bool or None."""

    image: np.ndarray
    bboxes_xyxy: np.ndarray
    labels: np.ndarray
    is_crowd: Optional[np.ndarray] = None

    def filter_valid(self, min_size: float = 1.0) -> "DetectionSample":
        w = self.bboxes_xyxy[:, 2] - self.bboxes_xyxy[:, 0]
        h = self.bboxes_xyxy[:, 3] - self.bboxes_xyxy[:, 1]
        keep = (w >= min_size) & (h >= min_size)
        return DetectionSample(
            self.image,
            self.bboxes_xyxy[keep],
            self.labels[keep],
            self.is_crowd[keep] if self.is_crowd is not None else None,
        )


class DetectionTransform:
    additional_samples_count: int = 0

    def __call__(self, sample: DetectionSample, rng: random.Random,
                 additional: Sequence[DetectionSample] = ()) -> DetectionSample:
        raise NotImplementedError


def _resize(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    return processing.resize(image.astype(np.uint8), out_hw)


def warp_affine(image: np.ndarray, m: np.ndarray, out_hw: Tuple[int, int], border_value: int) -> np.ndarray:
    """``cv2.warpAffine(image, m[:2], (w, h), INTER_LINEAR, BORDER_CONSTANT, border_value)``
    of an HWC uint8 image, for the 3x3 forward matrix ``m``."""
    th, tw = out_hw
    h, w = image.shape[:2]
    minv = np.linalg.inv(m)
    ys, xs = np.mgrid[0:th, 0:tw].astype(np.float64)
    sx = minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]
    sy = minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]
    grid = np.stack([2 * sx / max(w - 1, 1) - 1, 2 * sy / max(h - 1, 1) - 1], -1).astype(np.float32)
    src = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float() - border_value
    out = F.grid_sample(src, torch.from_numpy(grid)[None], mode="bilinear", padding_mode="zeros", align_corners=True)
    return (out[0].permute(1, 2, 0) + border_value).round().clamp(0, 255).to(torch.uint8).numpy()


_HSV_SHIFT = 12
_DIVISORS = np.arange(1, 256, dtype=np.float64)
# cv2's RGB2HSV_b tables: round((255 << 12) / i) and round((180 << 12) / (6 i)), 0 at i = 0
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _DIVISORS)]).astype(np.int32)
_HDIV180 = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _DIVISORS))]).astype(np.int32)


def rgb_to_hsv_u8(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_RGB2HSV)`` of an HWC uint8 image (H in [0, 180))."""
    px = image.astype(np.int32)  # every product below stays under 2**28
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    v = px.max(-1)
    diff = v - px.min(-1)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# sector -> the tab entries (v, v(1-s), v(1-sh), v(1-s(1-h))) that give b, g, r
_SECTOR_BGR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _fma_f32(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (the fp32 product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of an HWC uint8 image (H in [0, 180)), in
    the float32 arithmetic of cv2's vectorized ``HSV2RGB_b``: S and V scaled by 1/255,
    fused multiply-adds, the result times 255 truncated. (cv2's scalar loop, which takes
    the last few pixels of a row whose width is no multiple of its vector block, rounds
    instead: those pixels can differ by one grey level.)"""
    f32 = np.float32
    one = f32(1.0)
    h = hsv[..., 0].astype(f32) * (f32(6.0) / f32(180))
    s = hsv[..., 1].astype(f32) * (one / f32(255.0))
    v = hsv[..., 2].astype(f32) * (one / f32(255.0))
    sector = np.trunc(h)
    h = h - sector
    sector = sector.astype(np.int64) % 6
    tab = np.stack([v, v * (one - s), v * _fma_f32(-s, h, one), v * _fma_f32(-s, one - h, one)], -1)
    bgr = np.take_along_axis(tab, _SECTOR_BGR[sector], axis=-1)[..., ::-1] * f32(255.0)
    return np.clip(np.trunc(bgr), 0, 255).astype(np.uint8)


def add_weighted_half(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``cv2.addWeighted(a, 0.5, b, 0.5, 0)`` of two uint8 images: rounded half to even."""
    return np.rint((a.astype(np.float32) + b.astype(np.float32)) * np.float32(0.5)).astype(np.uint8)


class DetectionStandardize(DetectionTransform):
    """image / max_value, as float32. When it ends a dataset's chain the dataset skips
    it and ships uint8: the trainer standardizes on the device, bit-equal to this."""

    def __init__(self, max_value: float = 255.0):
        self.max_value = max_value

    def __call__(self, sample, rng, additional=()):
        img = np.multiply(sample.image, np.float32(1.0 / self.max_value), dtype=np.float32)
        return DetectionSample(img, sample.bboxes_xyxy, sample.labels, sample.is_crowd)


class DetectionHorizontalFlip(DetectionTransform):
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, sample, rng, additional=()):
        if rng.random() >= self.prob:
            return sample
        h, w = sample.image.shape[:2]
        img = sample.image[:, ::-1].copy()
        boxes = sample.bboxes_xyxy.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        return DetectionSample(img, boxes, sample.labels, sample.is_crowd)


class DetectionVerticalFlip(DetectionTransform):
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, sample, rng, additional=()):
        if rng.random() >= self.prob:
            return sample
        h, w = sample.image.shape[:2]
        img = sample.image[::-1].copy()
        boxes = sample.bboxes_xyxy.copy()
        boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
        return DetectionSample(img, boxes, sample.labels, sample.is_crowd)


class DetectionHSV(DetectionTransform):
    """Random hue / saturation / value shifts through per-channel LUTs on cv2's uint8 HSV."""

    def __init__(self, prob: float = 1.0, hgain: float = 5, sgain: float = 30, vgain: float = 30):
        self.prob, self.hgain, self.sgain, self.vgain = prob, hgain, sgain, vgain

    def __call__(self, sample, rng, additional=()):
        if rng.random() >= self.prob:
            return sample
        dh = rng.uniform(-self.hgain, self.hgain)
        ds = rng.uniform(-self.sgain, self.sgain)
        dv = rng.uniform(-self.vgain, self.vgain)
        idx = np.arange(256, dtype=np.int16)
        lut_h = ((idx + int(round(dh))) % 180).astype(np.uint8)
        lut_s = np.clip(idx + ds, 0, 255).astype(np.uint8)
        lut_v = np.clip(idx + dv, 0, 255).astype(np.uint8)
        cv2 = processing.cv2_module()
        if cv2 is not None:
            hsv = cv2.cvtColor(sample.image.astype(np.uint8), cv2.COLOR_RGB2HSV)
            hsv[..., 0] = cv2.LUT(hsv[..., 0], lut_h)
            hsv[..., 1] = cv2.LUT(hsv[..., 1], lut_s)
            hsv[..., 2] = cv2.LUT(hsv[..., 2], lut_v)
            out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        else:
            hsv = rgb_to_hsv_u8(sample.image.astype(np.uint8))
            hsv = np.stack([lut_h[hsv[..., 0]], lut_s[hsv[..., 1]], lut_v[hsv[..., 2]]], -1)
            out = hsv_to_rgb_u8(hsv)
        out = out.astype(sample.image.dtype)
        return DetectionSample(out, sample.bboxes_xyxy, sample.labels, sample.is_crowd)


class DetectionPaddedRescale(DetectionTransform):
    """Letterbox to ``input_dim`` with bottom-right padding."""

    def __init__(self, input_dim: Tuple[int, int] = (640, 640), pad_value: int = 114):
        self.input_dim = tuple(input_dim) if not isinstance(input_dim, int) else (input_dim, input_dim)
        self.pad_value = pad_value

    def __call__(self, sample, rng, additional=()):
        th, tw = self.input_dim
        h, w = sample.image.shape[:2]
        r = min(th / h, tw / w)
        nh, nw = round(h * r), round(w * r)
        resized = _resize(sample.image, (nh, nw))
        canvas = np.full((th, tw, 3), self.pad_value, dtype=resized.dtype)
        canvas[:nh, :nw] = resized
        boxes = sample.bboxes_xyxy * r
        return DetectionSample(canvas, boxes.astype(np.float32), sample.labels, sample.is_crowd)


class DetectionMosaic(DetectionTransform):
    """Four images on a 2x canvas around a random centre."""

    additional_samples_count = 3

    def __init__(self, input_dim: Tuple[int, int] = (640, 640), prob: float = 1.0):
        self.input_dim = tuple(input_dim) if not isinstance(input_dim, int) else (input_dim, input_dim)
        self.prob = prob

    def __call__(self, sample, rng, additional=()):
        if rng.random() >= self.prob or len(additional) < 3:
            return sample
        th, tw = self.input_dim
        yc = int(rng.uniform(0.5 * th, 1.5 * th))
        xc = int(rng.uniform(0.5 * tw, 1.5 * tw))
        canvas = np.full((th * 2, tw * 2, 3), 114, dtype=np.uint8)
        all_boxes, all_labels = [], []
        samples = [sample] + list(additional[:3])
        for i, s in enumerate(samples):
            h, w = s.image.shape[:2]
            scale = min(th / h, tw / w)
            nh, nw = int(h * scale), int(w * scale)
            img = _resize(s.image, (nh, nw))
            if i == 0:  # top-left
                x1a, y1a = max(xc - nw, 0), max(yc - nh, 0)
                x2a, y2a = xc, yc
                x1b, y1b = nw - (x2a - x1a), nh - (y2a - y1a)
            elif i == 1:  # top-right
                x1a, y1a = xc, max(yc - nh, 0)
                x2a, y2a = min(xc + nw, tw * 2), yc
                x1b, y1b = 0, nh - (y2a - y1a)
            elif i == 2:  # bottom-left
                x1a, y1a = max(xc - nw, 0), yc
                x2a, y2a = xc, min(yc + nh, th * 2)
                x1b, y1b = nw - (x2a - x1a), 0
            else:  # bottom-right
                x1a, y1a = xc, yc
                x2a, y2a = min(xc + nw, tw * 2), min(yc + nh, th * 2)
                x1b, y1b = 0, 0
            x2b, y2b = x1b + (x2a - x1a), y1b + (y2a - y1a)
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            if len(s.bboxes_xyxy):
                b = s.bboxes_xyxy * scale
                b[:, [0, 2]] += x1a - x1b
                b[:, [1, 3]] += y1a - y1b
                all_boxes.append(b)
                all_labels.append(s.labels)
        boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
        labels = np.concatenate(all_labels) if all_labels else np.zeros((0,), np.int32)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, tw * 2)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, th * 2)
        return DetectionSample(canvas, boxes.astype(np.float32), labels.astype(np.int32)).filter_valid(2.0)


class DetectionRandomAffine(DetectionTransform):
    """Random rotation, scale, shear and translation, warped with the forward matrix."""

    def __init__(
        self,
        degrees: float = 10.0,
        translate: float = 0.1,
        scales: Tuple[float, float] = (0.5, 1.5),
        shear: float = 2.0,
        target_size: Optional[Tuple[int, int]] = (640, 640),
        border_value: int = 114,
    ):
        self.degrees = degrees
        self.translate = translate
        self.scales = scales if isinstance(scales, (tuple, list)) else (1 - scales, 1 + scales)
        self.shear = shear
        self.target_size = tuple(target_size) if target_size else None
        self.border_value = border_value

    def __call__(self, sample, rng, additional=()):
        h, w = sample.image.shape[:2]
        th, tw = self.target_size or (h, w)

        angle = rng.uniform(-self.degrees, self.degrees)
        scale = rng.uniform(*self.scales)
        shear_x = math.tan(math.radians(rng.uniform(-self.shear, self.shear)))
        shear_y = math.tan(math.radians(rng.uniform(-self.shear, self.shear)))
        tx = rng.uniform(0.5 - self.translate, 0.5 + self.translate) * tw
        ty = rng.uniform(0.5 - self.translate, 0.5 + self.translate) * th

        a = math.radians(angle)
        # forward matrix: M = T(tx, ty) @ Shear @ Rot * scale @ T(-cx, -cy)
        cx, cy = w / 2, h / 2
        rot = np.array([[scale * math.cos(a), -scale * math.sin(a)], [scale * math.sin(a), scale * math.cos(a)]])
        sh = np.array([[1, shear_x], [shear_y, 1]])
        m2 = sh @ rot
        m = np.eye(3)
        m[:2, :2] = m2
        m[:2, 2] = [tx - cx * m2[0, 0] - cy * m2[0, 1], ty - cx * m2[1, 0] - cy * m2[1, 1]]
        cv2 = processing.cv2_module()
        if cv2 is not None:
            out_img = cv2.warpAffine(sample.image.astype(np.uint8), m[:2], dsize=(tw, th), flags=cv2.INTER_LINEAR,
                                     borderValue=(self.border_value,) * 3)
        else:
            out_img = warp_affine(sample.image.astype(np.uint8), m, (th, tw), self.border_value)

        if len(sample.bboxes_xyxy):
            corners = np.stack(
                [
                    sample.bboxes_xyxy[:, [0, 1]],
                    sample.bboxes_xyxy[:, [2, 1]],
                    sample.bboxes_xyxy[:, [0, 3]],
                    sample.bboxes_xyxy[:, [2, 3]],
                ],
                axis=1,
            )  # [N, 4, 2]
            ones = np.ones((*corners.shape[:2], 1))
            pts = np.concatenate([corners, ones], -1) @ m.T  # [N, 4, 3]
            xy = pts[..., :2]
            new_boxes = np.concatenate([xy.min(1), xy.max(1)], -1).astype(np.float32)
            new_boxes[:, [0, 2]] = new_boxes[:, [0, 2]].clip(0, tw)
            new_boxes[:, [1, 3]] = new_boxes[:, [1, 3]].clip(0, th)
        else:
            new_boxes = sample.bboxes_xyxy
        return DetectionSample(out_img, new_boxes, sample.labels, sample.is_crowd).filter_valid(2.0)


class DetectionMixup(DetectionTransform):
    """Blend with one additional image, both on canvases of their common size (pad 114)."""

    additional_samples_count = 1

    def __init__(self, prob: float = 0.5, mixup_scale: Tuple[float, float] = (0.5, 1.5)):
        self.prob = prob
        self.mixup_scale = mixup_scale

    def __call__(self, sample, rng, additional=()):
        if rng.random() >= self.prob or not additional:
            return sample
        other = additional[0]
        h = max(sample.image.shape[0], other.image.shape[0])
        w = max(sample.image.shape[1], other.image.shape[1])
        uint8 = sample.image.dtype == np.uint8 and other.image.dtype == np.uint8
        dtype = np.uint8 if uint8 else np.float32
        canvas_a = np.full((h, w, 3), 114, dtype)
        canvas_b = np.full((h, w, 3), 114, dtype)
        canvas_a[: sample.image.shape[0], : sample.image.shape[1]] = sample.image
        canvas_b[: other.image.shape[0], : other.image.shape[1]] = other.image
        cv2 = processing.cv2_module() if uint8 else None
        if cv2 is not None:
            blended = cv2.addWeighted(canvas_a, 0.5, canvas_b, 0.5, 0.0)
        elif uint8:
            blended = add_weighted_half(canvas_a, canvas_b)
        else:
            blended = (canvas_a * 0.5 + canvas_b * 0.5).astype(sample.image.dtype)
        boxes = np.concatenate([sample.bboxes_xyxy, other.bboxes_xyxy])
        labels = np.concatenate([sample.labels, other.labels])
        return DetectionSample(blended, boxes.astype(np.float32), labels.astype(np.int32))


class ComposeDetectionTransforms:
    def __init__(self, transforms: Sequence[DetectionTransform]):
        self.transforms = list(transforms)

    @property
    def additional_samples_count(self) -> int:
        return max([t.additional_samples_count for t in self.transforms] + [0])

    @property
    def trailing_standardize(self) -> Optional[DetectionStandardize]:
        """The chain's final DetectionStandardize, if any: a dataset skips it and the
        trainer applies it on the device (uint8 batches cross to the card)."""
        if self.transforms and isinstance(self.transforms[-1], DetectionStandardize):
            return self.transforms[-1]
        return None

    def __call__(self, sample: DetectionSample, rng: random.Random, additional: Sequence[DetectionSample] = (),
                 skip_trailing_standardize: bool = False) -> DetectionSample:
        transforms = self.transforms
        if skip_trailing_standardize and self.trailing_standardize is not None:
            transforms = transforms[:-1]
        for t in transforms:
            n = t.additional_samples_count
            sample = t(sample, rng, additional[:n] if n else ())
        return sample
