"""Bounding-box ops (counterpart of ``super_gradients_tpu/ops/bbox.py``).

Plain tensor functions over arbitrary leading batch dims; boxes are ``[..., 4]``
xyxy, the only format the predict path uses.
The arithmetic follows the JAX functions op for op (same order of additions,
same eps), so that on the CPU the two agree bit for bit.
"""

from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, clamped at 0."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    return w * h


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Pairwise IoU: ``[..., N, 4] x [..., M, 4] -> [..., N, M]``."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return inter / (union + eps)


def elementwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Aligned IoU: ``[..., 4]`` and ``[..., 4]`` of the same shape -> ``[...]``."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter / (union + eps)


def batch_distance2bbox(points: torch.Tensor, distance: torch.Tensor) -> torch.Tensor:
    """Decode (l, t, r, b) distances from anchor points ``[..., A, 2]`` into xyxy."""
    lt, rb = distance[..., :2], distance[..., 2:]
    return torch.cat([points - lt, points + rb], dim=-1)
