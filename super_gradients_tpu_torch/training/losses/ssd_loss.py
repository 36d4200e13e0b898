"""SSDLoss: anchor matching and hard-negative mining, batched and masked (counterpart of
``super_gradients_tpu/training/losses/ssd_loss.py``).

Targets arrive padded, ``[B, max_boxes, 5]`` rows of (cls, x1, y1, x2, y2) with
``cls = -1`` for padding. As in the JAX module:

- each anchor takes its best gt by IoU (``argmax`` over gts: the first on ties) and is
  positive at IoU >= ``iou_thresh``; each gt's best anchor (``argmax`` over anchors, the
  first on ties) is forced positive, an OR over the gts, but keeps its own best gt;
- smooth-L1 of the raw locs to the matched gt encoded on the anchor, on the positives;
- cross-entropy of the raw confs (class 0 the background) on the positives and on the
  ``min(neg_pos_ratio * pos, A - pos)`` negatives of highest CE in each image, ranked by a
  stable descending sort (the lowest index first among equal CEs, as ``jnp.argsort``);
- both terms divided by the positives of the whole batch (at least 1).

Without ``anchors_cxcywh`` the loss makes the SSD-lite-MobileNetV2 grid for ``image_size``,
as the recipes build it from ``criterion_params`` alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from super_gradients_tpu_torch.common.registry import register_loss
from super_gradients_tpu_torch.parallel.collectives import global_normalizer
from super_gradients_tpu_torch.ops.bbox import box_iou


def _cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1)


def _xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


@register_loss("SSDLoss")
class SSDLoss:
    def __init__(self, anchors_cxcywh=None, image_size: int = 320, scale_xy: float = 0.1, scale_wh: float = 0.2,
                 alpha: float = 1.0, iou_thresh: float = 0.5, neg_pos_ratio: float = 3.0):
        if anchors_cxcywh is None:
            from super_gradients_tpu_torch.models.detection.ssd import generate_ssd_anchors

            anchors_cxcywh = generate_ssd_anchors(image_size)
        self.anchors = torch.as_tensor(np.asarray(anchors_cxcywh, np.float32))
        self.scale_xy, self.scale_wh = scale_xy, scale_wh
        self.alpha = alpha
        self.iou_thresh = iou_thresh
        self.neg_pos_ratio = neg_pos_ratio
        self._device_anchors: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _anchors_on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cxcywh, xyxy) anchors on ``device``, made once a device."""
        if device not in self._device_anchors:
            a = self.anchors.to(device)
            self._device_anchors[device] = (a, _cxcywh_to_xyxy(a))
        return self._device_anchors[device]

    def _encode(self, gt_xyxy: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        g = _xyxy_to_cxcywh(gt_xyxy)
        dxy = (g[..., :2] - anchors[None, :, :2]) / anchors[None, :, 2:] / self.scale_xy
        dwh = torch.log((g[..., 2:] / anchors[None, :, 2:]).clamp(min=1e-8)) / self.scale_wh
        return torch.cat([dxy, dwh], -1)

    def match(self, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(positives [B, A] bool, matched gt row [B, A], conf target [B, A]) of the anchors."""
        anchors, anchors_xyxy = self._anchors_on(targets.device)
        gt_labels = targets[..., 0].clamp(min=0).long()
        gt_boxes = targets[..., 1:5]
        pad = (targets[..., 0] >= 0).to(gt_boxes.dtype)  # [B, n]
        b, n = pad.shape
        a = anchors.shape[0]
        ious = box_iou(gt_boxes, anchors_xyxy[None].expand(b, a, 4)) * pad[..., None]  # [B, n, A]
        best_gt_iou, best_gt_idx = ious.max(dim=1).values, ious.argmax(dim=1)  # [B, A]
        best_anchor_per_gt = ious.argmax(dim=2)  # [B, n]
        forced = torch.zeros(b, a, dtype=pad.dtype, device=ious.device).scatter_add_(1, best_anchor_per_gt, pad) > 0
        pos = (best_gt_iou >= self.iou_thresh) | forced
        matched_labels = torch.gather(gt_labels, 1, best_gt_idx) + 1  # 0 is the background
        return pos, best_gt_idx, torch.where(pos, matched_labels, torch.zeros_like(matched_labels))

    def hard_negatives(self, ce: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The mined negatives ``[B, A]`` (0 / 1 in ``ce``'s type): each image's
        ``min(neg_pos_ratio * pos, A - pos)`` negatives of highest CE, by a stable sort."""
        b, a = ce.shape
        neg_ce = torch.where(pos, torch.full_like(ce, -float("inf")), ce)
        order = torch.argsort(-neg_ce, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(1, order, torch.arange(a, device=order.device).expand(b, a))
        num_pos_img = pos.to(ce.dtype).sum(1, keepdim=True)
        return (rank < torch.minimum(self.neg_pos_ratio * num_pos_img, a - num_pos_img)).to(ce.dtype)

    def __call__(self, outputs, targets: torch.Tensor, *args) -> Tuple[torch.Tensor, Dict]:
        conf_logits = outputs.cls_logits  # [B, A, C + 1] raw
        loc_raw = outputs.reg_distri  # [B, A, 4] raw
        b, a, _ = loc_raw.shape
        anchors, _ = self._anchors_on(loc_raw.device)
        pos, best_gt_idx, conf_target = self.match(targets.to(loc_raw.device))
        pos_f = pos.to(loc_raw.dtype)
        num_pos = global_normalizer(pos_f.sum())  # the global batch's, shared out

        gt_boxes = targets[..., 1:5].to(loc_raw)
        matched_boxes = torch.gather(gt_boxes, 1, best_gt_idx[..., None].expand(b, a, 4))
        diff = (loc_raw - self._encode(matched_boxes, anchors)).abs()
        sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
        loc_loss = (sl1 * pos_f).sum() / num_pos

        logp = torch.log_softmax(conf_logits, -1)
        ce = -torch.gather(logp, -1, conf_target[..., None])[..., 0]  # [B, A]
        conf_loss = (ce * (pos_f + self.hard_negatives(ce.detach(), pos))).sum() / num_pos

        loss = self.alpha * loc_loss + conf_loss
        return loss, {"loc_loss": loc_loss.detach(), "conf_loss": conf_loss.detach()}
