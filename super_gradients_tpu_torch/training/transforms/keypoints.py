"""Keypoint (pose) transforms (counterpart of
``super_gradients_tpu/training/transforms/keypoints.py``).

Host-side numpy ops on a :class:`PoseSample` (an HWC image with each person's box and
joints). Every random decision draws from the ``random.Random`` passed in as ``rng``,
in the order in which the JAX transform draws from the global ``random``: for the same
seed both flip the same samples. The resize is the JAX package's PIL call
(``Image.BILINEAR``, the size rounded by Python's ``round``), imported at the call, so
images come out byte-equal.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Sequence

import numpy as np

#: COCO left/right joint swap order of a horizontal flip
COCO_FLIP_INDEX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


@dataclasses.dataclass
class PoseSample:
    image: np.ndarray  # HWC
    boxes_xyxy: np.ndarray  # [N, 4]
    joints: np.ndarray  # [N, J, 3] (x, y, visibility)

    def to_padded_targets(self, max_poses: int) -> np.ndarray:
        """``[max_poses, 5 + 3J]`` float32 rows (0, box, joints), ``-1`` rows pad."""
        n, k = self.joints.shape[:2]
        out = np.full((max_poses, 5 + 3 * k), -1.0, np.float32)
        m = min(n, max_poses)
        if m:
            out[:m, 0] = 0.0
            out[:m, 1:5] = self.boxes_xyxy[:m]
            out[:m, 5:] = self.joints[:m].reshape(m, -1)
        return out


class KeypointTransform:
    def __call__(self, sample: PoseSample, rng: random.Random) -> PoseSample:
        raise NotImplementedError


class KeypointsHorizontalFlip(KeypointTransform):
    """Horizontal flip with the left/right joints swapped by ``flip_index``."""

    def __init__(self, flip_index: Sequence[int] = tuple(COCO_FLIP_INDEX), prob: float = 0.5):
        self.flip_index = list(flip_index)
        self.prob = prob

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        h, w = sample.image.shape[:2]
        img = sample.image[:, ::-1].copy()
        boxes = sample.boxes_xyxy.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        joints = sample.joints[:, self.flip_index].copy()
        joints[..., 0] = w - joints[..., 0]
        return PoseSample(img, boxes, joints)


class KeypointsLongestMaxSize(KeypointTransform):
    """Rescale so the image fits ``max_height x max_width``, keeping its aspect ratio."""

    def __init__(self, max_height: int = 640, max_width: int = 640):
        self.max_hw = (max_height, max_width)

    def __call__(self, sample, rng):
        from PIL import Image

        h, w = sample.image.shape[:2]
        scale = min(self.max_hw[0] / h, self.max_hw[1] / w)
        nh, nw = round(h * scale), round(w * scale)
        img = np.asarray(Image.fromarray(sample.image.astype(np.uint8)).resize((nw, nh), Image.BILINEAR))
        joints = sample.joints.copy()
        joints[..., :2] *= scale
        return PoseSample(img, sample.boxes_xyxy * scale, joints)


class KeypointsPadIfNeeded(KeypointTransform):
    """Pad bottom and right up to ``min_height x min_width`` with ``image_pad_value``."""

    def __init__(self, min_height: int = 640, min_width: int = 640, image_pad_value: int = 114):
        self.min_hw = (min_height, min_width)
        self.pad_value = image_pad_value

    def __call__(self, sample, rng):
        h, w = sample.image.shape[:2]
        th, tw = max(h, self.min_hw[0]), max(w, self.min_hw[1])
        canvas = np.full((th, tw) + sample.image.shape[2:], self.pad_value, sample.image.dtype)
        canvas[:h, :w] = sample.image
        return PoseSample(canvas, sample.boxes_xyxy, sample.joints)


class KeypointsStandardize(KeypointTransform):
    """``image / max_value`` in float32 (a division, as in JAX: it differs from the
    detection chain's product with ``float32(1 / max_value)`` in the last bit of some
    pixels, so a pose dataset ships the float32 image it gives)."""

    def __init__(self, max_value: float = 255.0):
        self.max_value = max_value

    def __call__(self, sample, rng):
        return PoseSample(sample.image.astype(np.float32) / self.max_value, sample.boxes_xyxy, sample.joints)


class KeypointsRemoveSmallObjects(KeypointTransform):
    """Drop the persons with fewer visible joints than ``min_visible_joints`` or a box
    smaller than ``min_area``."""

    def __init__(self, min_visible_joints: int = 1, min_area: float = 64.0):
        self.min_visible_joints = min_visible_joints
        self.min_area = min_area

    def __call__(self, sample, rng):
        vis = (sample.joints[..., 2] > 0).sum(-1)
        area = np.clip(sample.boxes_xyxy[:, 2] - sample.boxes_xyxy[:, 0], 0, None) * np.clip(
            sample.boxes_xyxy[:, 3] - sample.boxes_xyxy[:, 1], 0, None
        )
        keep = (vis >= self.min_visible_joints) & (area >= self.min_area)
        return PoseSample(sample.image, sample.boxes_xyxy[keep], sample.joints[keep])


class ComposeKeypointTransforms:
    def __init__(self, transforms: Sequence[KeypointTransform]):
        self.transforms = list(transforms)

    def __call__(self, sample: PoseSample, rng: random.Random) -> PoseSample:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample
