"""YoloNASPoseLoss (counterpart of ``super_gradients_tpu/training/losses/yolo_nas_pose_loss.py``).

Targets arrive padded, ``[B, max_poses, 5 + 3J]`` rows of (valid flag: 0 a person,
-1 padding; x1, y1, x2, y2; then J x (x, y, visibility)). The loss is the PPYoloE
focal classification, GIoU and DFL terms of the single "person" class, plus an
OKS-style keypoint regression ``1 - exp(-d^2 / (2 sigma)^2 / area / 2)`` and a
per-joint visibility focal (or BCE) term, both over the assigned anchors.

The assigner is TAL on one class whose IoUs may be multiplied by the pose OKS.
With one class the background label is 1, so ``labels != 1`` marks the positive
anchors. A negative anchor's ``gt_index`` may point at a padding row (area 0): its
``exp(-e)`` is 0 and so is its gradient, and its weight is 0 besides. The helpers are
those of ``ppyolo_loss.py`` (stable top-k, ties to the lowest index); fp64 inputs
stay fp64 for the tests' fp64 reference runs. The alignment metric that ranks the
anchors has its subnormals flushed to 0, as in the JAX arithmetic (:func:`flush_subnormals`).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from super_gradients_tpu_torch.common.registry import register_loss
from super_gradients_tpu_torch.parallel.collectives import global_normalizer
from super_gradients_tpu_torch.models.class_names import COCO_POSE_SIGMAS
from super_gradients_tpu_torch.ops.bbox import batch_distance2bbox
from super_gradients_tpu_torch.ops.dfl import dfl_decode
from super_gradients_tpu_torch.training.losses.ppyolo_loss import (
    AssignResult,
    _at_least_f32,
    _bce_with_logits,
    _gather_assigned,
    _resolve_multiple,
    batch_iou_similarity,
    check_points_inside_bboxes,
    df_loss,
    flush_subnormals,
    focal_loss,
    gather_topk_anchors,
    giou_loss,
)


def batch_pose_oks(gt_kpts: torch.Tensor, pred_kpts: torch.Tensor, gt_bboxes: torch.Tensor, sigmas: torch.Tensor,
                   eps: float = 1e-9) -> torch.Tensor:
    """``[B, n, J, 3]`` gt x ``[B, L, J, 2]`` pred -> ``[B, n, L]`` mean OKS over the
    visible joints (the ``[B, n, L, J]`` distances are the largest tensor of the loss)."""
    d = ((gt_kpts[:, :, None, :, :2] - pred_kpts[:, None, :, :, :]) ** 2).sum(dim=-1)  # [B, n, L, J]
    area = (gt_bboxes[..., 2] - gt_bboxes[..., 0]) * (gt_bboxes[..., 3] - gt_bboxes[..., 1])  # [B, n]
    e = d / (2 * sigmas.reshape(1, 1, 1, -1)) ** 2 / (area[:, :, None, None] + eps) / 2
    oks = torch.exp(-e)
    vis = (gt_kpts[..., 2] > 0).to(d.dtype)[:, :, None, :]  # [B, n, 1, J]
    nv = vis.sum(dim=-1)
    return (oks * vis).sum(dim=-1) / (nv + eps)


class PoseTaskAlignedAssigner:
    """TAL for single-class pose; the IoUs optionally multiplied by the pose OKS."""

    def __init__(self, sigmas: Sequence[float], topk: int = 13, alpha: float = 1.0, beta: float = 6.0,
                 eps: float = 1e-9, multiply_by_pose_oks: bool = False):
        self.sigmas = torch.tensor(sigmas, dtype=torch.float32)
        self.topk, self.alpha, self.beta, self.eps = topk, alpha, beta, eps
        self.multiply_by_pose_oks = multiply_by_pose_oks

    @torch.no_grad()
    def __call__(
        self,
        pred_scores: torch.Tensor,  # [B, L, 1] sigmoid scores
        pred_bboxes: torch.Tensor,  # [B, L, 4] pixels
        pred_kpts: torch.Tensor,  # [B, L, J, 2] pixels
        anchor_points: torch.Tensor,  # [L, 2] pixels
        gt_bboxes: torch.Tensor,  # [B, n, 4]
        gt_kpts: torch.Tensor,  # [B, n, J, 3]
        pad_gt_mask: torch.Tensor,  # [B, n] 1 = real pose
    ) -> AssignResult:
        pad = pad_gt_mask[..., None]
        ious = batch_iou_similarity(gt_bboxes, pred_bboxes)
        if self.multiply_by_pose_oks:
            sigmas = self.sigmas.to(device=gt_kpts.device, dtype=gt_kpts.dtype)
            ious = ious * batch_pose_oks(gt_kpts, pred_kpts, gt_bboxes, sigmas)
        ious = ious * pad

        # one class: each gt's score at an anchor is the anchor's person score
        bbox_cls_scores = pred_scores[..., 0][:, None, :].expand_as(ious)
        alignment_metrics = flush_subnormals(bbox_cls_scores.pow(self.alpha) * ious.pow(self.beta))
        is_in_gts = check_points_inside_bboxes(anchor_points, gt_bboxes)
        is_in_topk = gather_topk_anchors(alignment_metrics * is_in_gts, self.topk, topk_mask=pad)
        mask_positive = _resolve_multiple(is_in_topk * is_in_gts * pad, ious)

        gt_labels = torch.zeros(gt_bboxes.shape[:2], dtype=torch.long, device=gt_bboxes.device)
        labels, bboxes, scores, gt_index = _gather_assigned(mask_positive, gt_labels, gt_bboxes, 1)

        alignment_metrics = alignment_metrics * mask_positive
        max_metrics_per_instance = alignment_metrics.amax(dim=-1, keepdim=True)
        max_ious_per_instance = (ious * mask_positive).amax(dim=-1, keepdim=True)
        alignment_metrics = alignment_metrics / (max_metrics_per_instance + self.eps) * max_ious_per_instance
        scores = scores * alignment_metrics.amax(dim=-2)[..., None]
        return AssignResult(labels, bboxes, scores, gt_index)


@register_loss("YoloNASPoseLoss")
class YoloNASPoseLoss:
    """``loss(outputs, targets)`` takes the model's ``YoloNASPoseOutputs`` (fp32) and
    targets ``[B, max_poses, 5 + 3J]``; returns ``(loss, {"loss_cls", "loss_iou",
    "loss_dfl", "loss_pose_cls", "loss_pose_reg"})``."""

    def __init__(
        self,
        num_joints: int = 17,
        oks_sigmas: Sequence[float] = tuple(COCO_POSE_SIGMAS),
        classification_loss_weight: float = 1.0,
        iou_loss_weight: float = 2.5,
        dfl_loss_weight: float = 0.5,
        pose_cls_loss_weight: float = 1.0,
        pose_reg_loss_weight: float = 34.0,
        assigner_multiply_by_pose_oks: bool = True,
        rescale_pose_loss_with_assigned_score: bool = True,
        pose_classification_loss_type: str = "focal",
    ):
        if oks_sigmas is None:
            # the JAX loss fails on None too (ROADMAP.md section 3): the sigmas have no default to fall to
            raise ValueError("YoloNASPoseLoss: oks_sigmas is None; pass one sigma a joint")
        self.num_joints = num_joints
        self.sigmas = torch.tensor(oks_sigmas, dtype=torch.float32)
        self.classification_loss_weight = classification_loss_weight
        self.iou_loss_weight = iou_loss_weight
        self.dfl_loss_weight = dfl_loss_weight
        self.pose_cls_loss_weight = pose_cls_loss_weight
        self.pose_reg_loss_weight = pose_reg_loss_weight
        self.rescale_pose_loss = rescale_pose_loss_with_assigned_score
        self.pose_cls_type = pose_classification_loss_type
        self.assigner = PoseTaskAlignedAssigner(oks_sigmas, topk=13, alpha=1.0, beta=6.0,
                                                multiply_by_pose_oks=assigner_multiply_by_pose_oks)

    def _decode_and_assign(self, outputs, targets: torch.Tensor):
        k = self.num_joints
        gt_bboxes = targets[..., 1:5]
        gt_kpts = targets[..., 5 : 5 + 3 * k].reshape(*targets.shape[:2], k, 3)
        cls_logits, reg_distri = _at_least_f32(outputs.cls_logits), outputs.reg_distri
        pad_gt_mask = (targets[..., 0] >= 0).to(cls_logits.dtype)
        points_s, stride_t = outputs.anchor_points, outputs.stride_tensor  # stride units, [L, 1]
        b, num_anchors, _ = cls_logits.shape
        reg_max = reg_distri.shape[-1] // 4 - 1

        # predicted boxes in stride units; the gradient flows through them into the IoU loss
        pred_dist_4 = _at_least_f32(reg_distri).reshape(b, num_anchors, 4, reg_max + 1)
        pred_bboxes_s = batch_distance2bbox(points_s, dfl_decode(pred_dist_4, reg_max))
        assign = self.assigner(
            pred_scores=torch.sigmoid(cls_logits.detach()),
            pred_bboxes=pred_bboxes_s.detach() * stride_t[None],
            pred_kpts=outputs.pred_pose_coords.detach(),
            anchor_points=points_s * stride_t,
            gt_bboxes=gt_bboxes,
            gt_kpts=gt_kpts,
            pad_gt_mask=pad_gt_mask,
        )
        return cls_logits, pred_dist_4, pred_bboxes_s, gt_kpts, reg_max, assign

    def assign(self, outputs, targets: torch.Tensor) -> AssignResult:
        """The assigner's labels, boxes, scores and gt indices for these outputs (no gradient)."""
        return self._decode_and_assign(outputs, targets)[-1]

    def __call__(self, outputs, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cls_logits, pred_dist_4, pred_bboxes_s, gt_kpts, reg_max, assign = self._decode_and_assign(outputs, targets)
        points_s, stride_t = outputs.anchor_points, outputs.stride_tensor
        dtype = cls_logits.dtype

        cls_loss_sum = focal_loss(cls_logits[..., 0], assign.scores[..., 0], alpha=-1.0)
        assigned_scores_sum = global_normalizer(assign.scores.sum())

        mask_positive = (assign.labels != 1).to(dtype)  # background index 1: one class
        bbox_weight = assign.scores[..., 0] * mask_positive
        assigned_bboxes_s = assign.bboxes / stride_t[None]
        iou_loss_sum = torch.sum(giou_loss(pred_bboxes_s, assigned_bboxes_s) * bbox_weight)
        assigned_ltrb = torch.cat([points_s - assigned_bboxes_s[..., :2], assigned_bboxes_s[..., 2:] - points_s], -1)
        assigned_ltrb = assigned_ltrb.clamp(0, reg_max - 0.01)
        dfl_loss_sum = torch.sum(df_loss(pred_dist_4, assigned_ltrb) * bbox_weight)

        # keypoints, masked over every anchor (the weights are 0 at the negatives)
        b, a = assign.gt_index.shape
        k = self.num_joints
        assigned_kpts = torch.gather(gt_kpts, 1, assign.gt_index[:, :, None, None].expand(b, a, k, 3))  # [B, A, J, 3]
        area = (assign.bboxes[..., 2] - assign.bboxes[..., 0]) * (assign.bboxes[..., 3] - assign.bboxes[..., 1])
        vis = (assigned_kpts[..., 2] > 0).to(dtype)  # [B, A, J]
        pred_pose_px = outputs.pred_pose_coords
        sigmas = self.sigmas.to(device=pred_pose_px.device, dtype=pred_pose_px.dtype)
        d = ((pred_pose_px - assigned_kpts[..., :2]) ** 2).sum(dim=-1)  # [B, A, J]
        e = d / (2 * sigmas.reshape(1, 1, -1)) ** 2 / (area[..., None] + 1e-9) / 2
        reg_unreduced = 1.0 - torch.exp(-e)
        reg_per_anchor = (reg_unreduced * vis).sum(dim=-1) / (vis.sum(dim=-1) + 1e-9)  # [B, A]

        pose_logits = _at_least_f32(outputs.pose_logits)
        if self.pose_cls_type == "focal":
            p = torch.sigmoid(pose_logits)
            w = (p - vis).abs() ** 2.0
            alpha_t = 0.25 * vis + 0.75 * (1 - vis)
            pose_cls_per_anchor = (alpha_t * w * _bce_with_logits(pose_logits, vis)).mean(dim=-1)
        else:
            pose_cls_per_anchor = _bce_with_logits(pose_logits, vis).mean(dim=-1)

        if self.rescale_pose_loss:
            pose_w, denom = bbox_weight, assigned_scores_sum
        else:
            pose_w, denom = mask_positive, global_normalizer(mask_positive.sum())
        pose_reg_sum = torch.sum(reg_per_anchor * pose_w)
        pose_cls_sum = torch.sum(pose_cls_per_anchor * pose_w)

        cls_loss = self.classification_loss_weight * cls_loss_sum / assigned_scores_sum
        iou_loss = self.iou_loss_weight * iou_loss_sum / assigned_scores_sum
        dfl_loss = self.dfl_loss_weight * dfl_loss_sum / assigned_scores_sum
        pose_cls_loss = self.pose_cls_loss_weight * pose_cls_sum / denom
        pose_reg_loss = self.pose_reg_loss_weight * pose_reg_sum / denom
        loss = cls_loss + iou_loss + dfl_loss + pose_cls_loss + pose_reg_loss
        return loss, {
            "loss_cls": cls_loss,
            "loss_iou": iou_loss,
            "loss_dfl": dfl_loss,
            "loss_pose_cls": pose_cls_loss,
            "loss_pose_reg": pose_reg_loss,
        }
