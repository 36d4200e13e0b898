"""Host-side image processing for predict (the subset of
``super_gradients_tpu/inference/processing.py`` that YOLO-NAS COCO processing uses).

numpy in, numpy out, one image at a time. The bilinear resize is
``F.interpolate(mode="bilinear", align_corners=False, antialias=False)`` rounded
back to uint8, in place of cv2's ``INTER_LINEAR`` (the same half-pixel sampling;
cv2's fixed-point weights make the two differ by at most one grey level).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class ProcessingMetadata:
    scale: float = 1.0
    pad_top: int = 0
    pad_left: int = 0
    original_hw: Tuple[int, int] = (0, 0)


class Processing:
    """preprocess(image) -> (image, metadata); postprocess_boxes undoes the geometry."""

    def preprocess_image(self, image: np.ndarray) -> Tuple[np.ndarray, ProcessingMetadata]:
        raise NotImplementedError

    def postprocess_boxes(self, boxes: np.ndarray, meta: ProcessingMetadata) -> np.ndarray:
        return boxes


def resize_bilinear(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an HWC uint8 image (half-pixel centers, no antialias)."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


class DetectionLongestMaxSizeRescale(Processing):
    """Rescale so the longest side fits output_shape, keeping aspect ratio."""

    def __init__(self, output_shape: Sequence[int]):
        self.output_shape = tuple(output_shape)

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        th, tw = self.output_shape
        scale = min(th / h, tw / w)
        if scale != 1.0:
            image = resize_bilinear(image, (round(h * scale), round(w * scale)))
        return image, ProcessingMetadata(scale=scale, original_hw=(h, w))

    def postprocess_boxes(self, boxes, meta):
        return boxes / meta.scale


class DetectionBottomRightPadding(Processing):
    def __init__(self, output_shape: Sequence[int], pad_value: int = 114):
        self.output_shape = tuple(output_shape)
        self.pad_value = pad_value

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        th, tw = self.output_shape
        out = np.full((th, tw) + image.shape[2:], self.pad_value, dtype=image.dtype)
        out[:h, :w] = image
        return out, ProcessingMetadata(original_hw=(h, w))


class DetectionCenterPadding(Processing):
    def __init__(self, output_shape: Sequence[int], pad_value: int = 114):
        self.output_shape = tuple(output_shape)
        self.pad_value = pad_value

    def preprocess_image(self, image):
        h, w = image.shape[:2]
        th, tw = self.output_shape
        top, left = (th - h) // 2, (tw - w) // 2
        out = np.full((th, tw) + image.shape[2:], self.pad_value, dtype=image.dtype)
        out[top : top + h, left : left + w] = image
        return out, ProcessingMetadata(pad_top=top, pad_left=left, original_hw=(h, w))

    def postprocess_boxes(self, boxes, meta):
        shift = np.array([meta.pad_left, meta.pad_top, meta.pad_left, meta.pad_top], dtype=boxes.dtype)
        return boxes - shift


class StandardizeImage(Processing):
    def __init__(self, max_value: float = 255.0):
        self.max_value = max_value

    def preprocess_image(self, image):
        return image.astype(np.float32) / self.max_value, ProcessingMetadata(original_hw=image.shape[:2])


class ComposeProcessing(Processing):
    """Sequential composition; the metadata is the list of (op, metadata) pairs."""

    def __init__(self, processings: Sequence[Processing]):
        self.processings = list(processings)

    def preprocess_image(self, image):
        metas: List[Tuple[Processing, ProcessingMetadata]] = []
        for p in self.processings:
            image, meta = p.preprocess_image(image)
            metas.append((p, meta))
        return image, metas

    def postprocess_boxes(self, boxes, metas):
        for p, m in reversed(metas):
            boxes = p.postprocess_boxes(boxes, m)
        return boxes


def default_yolo_nas_coco_processing(image_size: int = 640) -> ComposeProcessing:
    """The published YOLO-NAS COCO processing: LongestMaxSizeRescale(636, 636) +
    CenterPadding(640, 640) + /255 (at image_size 640)."""
    return ComposeProcessing(
        [
            DetectionLongestMaxSizeRescale((image_size - 4, image_size - 4)),
            DetectionCenterPadding((image_size, image_size), 114),
            StandardizeImage(255.0),
        ]
    )
