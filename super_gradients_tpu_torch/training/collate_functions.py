"""Detection collate functions (counterpart of
``super_gradients_tpu/training/collate_functions.py``).

Samples are the port's detection samples: a ``[3, H, W]`` image (uint8 where the
dataset ships it for the device to standardize) and padded ``[max_boxes, 5 or 6]``
targets ``(label, x1, y1, x2, y2[, is_crowd])`` in pixels, -1 for padding; crowd
samples carry a third element, the crowd targets. A collate returns torch tensors:
images ``[B, 3, H, W]`` in the samples' dtype and the stacked targets.

``PPYoloECollateFN`` resizes a batch to one size drawn per batch, then its interpolation
mode, from ``np.random.RandomState(seed)``: the JAX package's draws. The resize is its
``cv2.resize`` where cv2 imports (byte-equal to JAX), else the JAX fallback through PIL,
imported at the call.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from super_gradients_tpu_torch.common.registry import create_register_decorator
from super_gradients_tpu_torch.inference import processing

COLLATE_FUNCTIONS: dict = {}
register_collate_function = create_register_decorator(COLLATE_FUNCTIONS)


def _resize_image(image: np.ndarray, hw: Tuple[int, int], mode: int) -> np.ndarray:
    """Resize an HWC image to ``hw`` with cv2 interpolation ``mode`` (PIL's filter of that
    number without cv2; a float image goes through PIL as uint8 of ``image * 255``)."""
    cv2 = processing.cv2_module()
    if cv2 is not None:
        return cv2.resize(image, dsize=(int(hw[1]), int(hw[0])), interpolation=int(mode))
    from PIL import Image

    pil_modes = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC, 3: Image.BOX, 4: Image.LANCZOS}
    arr = (image * 255).astype(np.uint8) if image.dtype != np.uint8 else image
    scaled = np.asarray(Image.fromarray(arr).resize((int(hw[1]), int(hw[0])), pil_modes.get(int(mode), Image.BILINEAR)))
    return scaled.astype(image.dtype) / (255.0 if image.dtype != np.uint8 else 1)


def _stack(column) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(s) for s in column]))


@register_collate_function("DetectionCollateFN")
class DetectionCollateFN:
    """Stack (image, padded-target) pairs."""

    expected_item_names = ("image", "targets")

    def __call__(self, samples: Sequence[Tuple]) -> Tuple[torch.Tensor, torch.Tensor]:
        return _stack(s[0] for s in samples), _stack(s[1] for s in samples)


@register_collate_function("PPYoloECollateFN")
class PPYoloECollateFN(DetectionCollateFN):
    """Multi-scale batch collate: one target size drawn per batch from a fixed set, the
    images resized to it and the valid boxes rescaled."""

    def __init__(
        self,
        random_resize_sizes: Optional[List[int]] = None,
        random_resize_modes: Optional[List[int]] = None,
        random_aspect_ratio: Union[bool, Tuple[float, float]] = False,
        seed: int = 0,
    ):
        if random_resize_sizes is not None:
            sizes = np.array(list(itertools.product(random_resize_sizes, random_resize_sizes)))  # [N, 2] (h, w)
            if random_aspect_ratio is False:
                sizes = sizes[sizes[:, 0] == sizes[:, 1]]
            elif random_aspect_ratio is True:
                pass
            elif isinstance(random_aspect_ratio, (tuple, list)):
                lo, hi = random_aspect_ratio
                if lo > hi:
                    raise ValueError(f"min_aspect_ratio {lo} must be <= max_aspect_ratio {hi}")
                ar = sizes[:, 0] / sizes[:, 1]
                sizes = sizes[(ar >= lo) & (ar <= hi)]
                if len(sizes) == 0:
                    raise ValueError(f"random_aspect_ratio={random_aspect_ratio} leaves no valid size combinations")
            else:
                raise ValueError(f"Unsupported random_aspect_ratio value: {random_aspect_ratio}")
            self.random_resize_sizes = sizes
        else:
            self.random_resize_sizes = None
        self.random_resize_modes = list(random_resize_modes) if random_resize_modes is not None else [1]
        self._rng = np.random.RandomState(seed)

    def __repr__(self):
        return f"PPYoloECollateFN(random_resize_sizes={self.random_resize_sizes}, random_resize_modes={self.random_resize_modes})"

    def __call__(self, samples: Sequence[Tuple]):
        if self.random_resize_sizes is not None:
            samples = self.random_resize(samples)
        return super().__call__(samples)

    def random_resize(self, samples):
        hw = self.random_resize_sizes[self._rng.randint(len(self.random_resize_sizes))]
        mode = self.random_resize_modes[self._rng.randint(len(self.random_resize_modes))]
        return [self.random_resize_sample(s, (int(hw[0]), int(hw[1])), mode) for s in samples]

    @staticmethod
    def random_resize_sample(sample, target_hw: Tuple[int, int], interpolation: int):
        image, targets = np.asarray(sample[0]), np.asarray(sample[1]).copy()
        th, tw = target_hw
        sy, sx = th / image.shape[1], tw / image.shape[2]
        hwc = _resize_image(np.ascontiguousarray(image.transpose(1, 2, 0)), (th, tw), interpolation)
        image = np.ascontiguousarray(hwc.reshape(th, tw, -1).transpose(2, 0, 1))
        valid = targets[:, 0] >= 0
        targets[valid, 1:5] = targets[valid, 1:5] * np.array([sx, sy, sx, sy], dtype=targets.dtype)
        if len(sample) == 3:  # crowd variant
            crowd = np.asarray(sample[2]).copy()
            cvalid = crowd[:, 0] >= 0
            crowd[cvalid, 1:5] = crowd[cvalid, 1:5] * np.array([sx, sy, sx, sy], dtype=crowd.dtype)
            return image, targets, crowd
        return image, targets


@register_collate_function("CrowdDetectionCollateFN")
class CrowdDetectionCollateFN(DetectionCollateFN):
    """Stack (image, targets, crowd_targets) triples."""

    expected_item_names = ("image", "targets", "crowd_targets")

    def __call__(self, samples):
        return tuple(_stack(s[i] for s in samples) for i in range(3))


@register_collate_function("CrowdDetectionPPYoloECollateFN")
class CrowdDetectionPPYoloECollateFN(PPYoloECollateFN):
    """Multi-scale resize of crowd triples."""

    expected_item_names = ("image", "targets", "crowd_targets")

    def __call__(self, samples):
        if self.random_resize_sizes is not None:
            samples = self.random_resize(samples)
        return tuple(_stack(s[i] for s in samples) for i in range(3))
