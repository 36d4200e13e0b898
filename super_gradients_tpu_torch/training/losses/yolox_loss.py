"""YoloXDetectionLoss: SimOTA dynamic-k assignment, batched and masked (counterpart of
``super_gradients_tpu/training/losses/yolox_loss.py``).

Targets arrive padded, ``[B, max_boxes, 5]`` rows of (cls, x1, y1, x2, y2) with
``cls = -1`` for padding (a sixth ``is_crowd`` column is ignored, as in JAX). The
assignment runs under ``torch.no_grad()`` where the JAX module stops gradients:

- the centre prior: an anchor centre inside the gt box or within ``center_radius``
  strides of its centre;
- the cost ``cls + 3 * (-log IoU) + 1e6 * (outside the prior)``, the class term the BCE
  of ``sqrt(score)`` against the gt's one-hot, summed over the classes. The port sums
  the negative class terms once per anchor and corrects the gt class's term, where the
  JAX module builds the ``[B, n, A, C]`` tensor (5 GB at b16 with 120 boxes and 80
  classes); the sums agree to float32 rounding;
- dynamic k from each gt's top-10 prior IoUs, the ``dynamic_k`` lowest-cost anchors (a
  stable sort: ties to the lowest index, as ``lax.top_k``), and an anchor matched by
  several gts kept by the lowest-cost one (``argmin``, the first on ties, as ``jnp``).

Losses: objectness BCE over every anchor, class BCE to the one-hot and ``1 - IoU^2`` on
the positives, and with ``use_l1`` the L1 of the raw regression to its encoded target,
each normalized by the positives' count.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from super_gradients_tpu_torch.common.environment import get_world_size
from super_gradients_tpu_torch.common.registry import register_loss
from super_gradients_tpu_torch.parallel.collectives import global_normalizer
from super_gradients_tpu_torch.ops.bbox import box_iou, elementwise_iou
from super_gradients_tpu_torch.training.losses.ppyolo_loss import _bce_with_logits, _sorted_indices


class SimOTAResult(NamedTuple):
    fg_mask: torch.Tensor  # [B, A] bool
    matched_gt: torch.Tensor  # [B, A] int64, the gt row of each foreground anchor
    matched_iou: torch.Tensor  # [B, A]


def _targets(targets: torch.Tensor):
    """(gt labels, gt boxes, padding mask) of padded ``[B, n, 5+]`` targets."""
    gt_boxes = targets[..., 1:5]
    return targets[..., 0].clamp(min=0).long(), gt_boxes, (targets[..., 0] >= 0).to(gt_boxes.dtype)


@register_loss("YoloXDetectionLoss")
@register_loss("YoloXFastDetectionLoss")
class YoloXDetectionLoss:
    component_names = ["iou", "obj", "cls", "l1", "num_fg", "Loss"]

    def __init__(
        self,
        num_classes: int = 80,
        strides=(8, 16, 32),
        center_radius: float = 2.5,
        simota_topk: int = 10,
        iou_weight: float = 5.0,
        obj_weight: float = 1.0,
        cls_weight: float = 1.0,
        use_l1: bool = False,
    ):
        self.num_classes = num_classes
        self.center_radius = center_radius
        self.topk = simota_topk
        self.iou_weight = iou_weight
        self.obj_weight = obj_weight
        self.cls_weight = cls_weight
        self.use_l1 = use_l1

    def costs(self, pred_boxes, pred_scores, points_px, strides, gt_boxes, gt_labels, pad_mask):
        """(prior [B, n, A] bool, ious [B, n, A], cost [B, n, A]) of SimOTA."""
        px, py = points_px[:, 0], points_px[:, 1]
        in_box = ((px >= gt_boxes[..., 0:1]) & (px <= gt_boxes[..., 2:3])
                  & (py >= gt_boxes[..., 1:2]) & (py <= gt_boxes[..., 3:4]))  # [B, n, A]
        gcx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5
        gcy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5
        r = self.center_radius * strides[:, 0]  # [A]
        in_center = ((px - gcx[..., None]).abs() < r) & ((py - gcy[..., None]).abs() < r)
        prior = (in_box | in_center) & (pad_mask[..., None] > 0)

        ious = box_iou(gt_boxes, pred_boxes) * pad_mask[..., None]
        iou_cost = -torch.log(ious + 1e-8)

        p = torch.sqrt(pred_scores.clamp(1e-8, 1.0))  # [B, A, C]
        log_p, log_not_p = torch.log(p), torch.log(1 - p + 1e-8)
        neg_sum = -log_not_p.sum(dim=-1)  # [B, A]: every class taken as negative
        b, a, c = p.shape
        idx = gt_labels[:, :, None].expand(b, gt_labels.shape[1], a)  # [B, n, A]
        gt_log_p = torch.gather(log_p.transpose(1, 2), 1, idx)  # [B, n, A]: log p of the gt's class
        gt_log_not_p = torch.gather(log_not_p.transpose(1, 2), 1, idx)
        cls_cost = neg_sum[:, None, :] + gt_log_not_p - gt_log_p
        cost = cls_cost + 3.0 * iou_cost + 1e6 * (~prior).to(cls_cost.dtype)
        return prior, ious, cost

    def assign(self, outputs, targets: torch.Tensor) -> SimOTAResult:
        """The SimOTA assignment of these outputs (no gradient)."""
        gt_labels, gt_boxes, pad_mask = _targets(targets)
        st = outputs.stride_tensor
        points_px = outputs.anchor_points * st[:, 0:1] + st * 0.5
        return self._assign(outputs.pred_bboxes.detach(), outputs.pred_scores.detach(), points_px, st, gt_boxes,
                            gt_labels, pad_mask)

    @torch.no_grad()
    def _assign(self, pred_boxes, pred_scores, points_px, strides, gt_boxes, gt_labels, pad_mask) -> SimOTAResult:
        """SimOTA over the batch -> fg_mask [B, A], matched_gt [B, A], matched_iou [B, A]."""
        b, a, _ = pred_boxes.shape
        n = gt_boxes.shape[1]
        prior, ious, cost = self.costs(pred_boxes, pred_scores, points_px, strides, gt_boxes, gt_labels, pad_mask)

        k = min(self.topk, a)
        topk_ious = torch.topk(torch.where(prior, ious, torch.zeros_like(ious)), k, dim=-1).values
        dynamic_k = topk_ious.sum(-1).to(torch.int32).clamp(1, k)  # [B, n]

        cand_idx = _sorted_indices(cost, descending=False)[..., :k]  # [B, n, k], lowest cost first
        chosen = torch.arange(k, device=cost.device) < dynamic_k[..., None]
        matching = torch.zeros_like(cost).scatter_(-1, cand_idx, chosen.to(cost.dtype)) * prior

        multi = matching.sum(1, keepdim=True) > 1  # [B, 1, A]
        best_gt = torch.where(matching > 0, cost, torch.full_like(cost, 1e9)).argmin(dim=1)  # [B, A]
        keep_best = F.one_hot(best_gt, n).transpose(1, 2).to(matching.dtype)  # [B, n, A]
        matching = torch.where(multi, matching * keep_best, matching)

        fg_mask = matching.sum(1) > 0
        matched_gt = matching.argmax(dim=1)
        matched_iou = (ious * matching).max(dim=1).values
        return SimOTAResult(fg_mask, matched_gt, matched_iou)

    def __call__(self, outputs, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        gt_labels, gt_boxes, _ = _targets(targets)
        pred_boxes, st = outputs.pred_bboxes, outputs.stride_tensor
        fg, matched_gt, _ = self.assign(outputs, targets)
        fg_f = fg.to(pred_boxes.dtype)
        denom = global_normalizer(fg_f.sum())  # the global batch's, shared out
        num_fg = denom * get_world_size()  # the global batch's, as logged

        obj_loss = _bce_with_logits(outputs.obj_logits, fg_f).sum() / denom

        tgt_labels = torch.gather(gt_labels, 1, matched_gt)
        tgt_onehot = F.one_hot(tgt_labels, self.num_classes).to(outputs.cls_logits.dtype)
        cls_loss = (_bce_with_logits(outputs.cls_logits, tgt_onehot).sum(-1) * fg_f).sum() / denom

        tgt_boxes = torch.gather(gt_boxes, 1, matched_gt[..., None].expand(*matched_gt.shape, 4))
        iou = elementwise_iou(pred_boxes, tgt_boxes)
        iou_loss = ((1.0 - iou ** 2) * fg_f).sum() / denom

        loss = self.iou_weight * iou_loss + self.obj_weight * obj_loss + self.cls_weight * cls_loss
        aux = {"iou": iou_loss, "obj": obj_loss, "cls": cls_loss, "num_fg": num_fg}
        if self.use_l1:
            s = st[None, :, 0]
            tcx = (tgt_boxes[..., 0] + tgt_boxes[..., 2]) * 0.5
            tcy = (tgt_boxes[..., 1] + tgt_boxes[..., 3]) * 0.5
            tw = tgt_boxes[..., 2] - tgt_boxes[..., 0]
            th = tgt_boxes[..., 3] - tgt_boxes[..., 1]
            l1_target = torch.stack([
                tcx / s - outputs.anchor_points[None, :, 0],
                tcy / s - outputs.anchor_points[None, :, 1],
                torch.log((tw / s).clamp(min=1e-8)),
                torch.log((th / s).clamp(min=1e-8)),
            ], -1)
            l1 = ((outputs.reg_raw - l1_target).abs() * fg_f[..., None]).sum() / denom
            loss = loss + l1
            aux["l1"] = l1
        return loss, aux
