"""PPYoloELoss with the TAL and ATSS assigners (counterpart of
``super_gradients_tpu/training/losses/ppyolo_loss.py``).

Targets arrive padded, ``[B, max_boxes, 5]`` rows of (cls, x1, y1, x2, y2) with
``cls = -1`` for padding, plus an optional sixth ``is_crowd`` column. Every branch
of the JAX module is an unconditional mask here too, so padding rows are no-ops.

Where the JAX module multiplies by one-hot matrices to keep the TPU's matrix unit
busy, the port gathers (``torch.gather`` / ``scatter_``). Each of those products
has a single non-zero term, so the gather gives the same bits. Top-k selections
keep the JAX tie order, the lowest index first: a stable sort, since
``torch.topk`` promises no order among equal values on CUDA. The TAL alignment
metric has its subnormals flushed to 0, as XLA's arithmetic leaves them
(:func:`flush_subnormals`). The assigners run under ``torch.no_grad()`` where the
JAX module stops gradients.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from super_gradients_tpu_torch.common.registry import register_loss
from super_gradients_tpu_torch.parallel.collectives import global_normalizer
from super_gradients_tpu_torch.ops.bbox import batch_distance2bbox, box_iou
from super_gradients_tpu_torch.ops.dfl import dfl_decode

# ------------------------------------------------------------------ support ops


def batch_iou_similarity(gt_bboxes: torch.Tensor, pred_bboxes: torch.Tensor) -> torch.Tensor:
    """[B, n, 4] x [B, L, 4] -> [B, n, L] IoU."""
    return box_iou(gt_bboxes, pred_bboxes)


def check_points_inside_bboxes(points: torch.Tensor, bboxes: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """points [L, 2], bboxes [B, n, 4] -> [B, n, L] float 0/1: the point lies more
    than ``eps`` inside each side of the box."""
    x, y = points[:, 0], points[:, 1]
    xmin, ymin, xmax, ymax = (bboxes[..., i : i + 1] for i in range(4))  # each [B, n, 1]
    nearest = torch.minimum(torch.minimum(x - xmin, y - ymin), torch.minimum(xmax - x, ymax - y))
    return (nearest > eps).to(bboxes.dtype)


def flush_subnormals(t: torch.Tensor) -> torch.Tensor:
    """Subnormal values to 0, as the JAX reference's arithmetic leaves them (XLA flushes
    subnormals on the CPU and the TPU; PyTorch keeps them). A TAL alignment metric
    ``score * IoU^6`` falls there for anchors whose box barely overlaps the gt, and a
    subnormal would outrank the zeros that JAX's top-k orders by index."""
    return torch.where(t.abs() < torch.finfo(t.dtype).tiny, torch.zeros_like(t), t)


def _sorted_indices(vals: torch.Tensor, descending: bool) -> torch.Tensor:
    """Indices along the last dim in value order, equal values in index order
    (the order of ``lax.top_k`` and of an argmax that takes the first max)."""
    return torch.sort(vals, dim=-1, descending=descending, stable=True).indices


def gather_topk_anchors(metrics: torch.Tensor, topk: int, topk_mask: torch.Tensor) -> torch.Tensor:
    """metrics [B, n, L] -> 0/1 [B, n, L] marking each gt's ``topk`` largest anchors,
    times ``topk_mask``. The JAX ``largest=False`` branch without a mask is not
    ported: no caller reaches it."""
    k = min(topk, metrics.shape[-1])
    idx = _sorted_indices(metrics, descending=True)[..., :k]
    return torch.zeros_like(metrics).scatter_(-1, idx, 1.0) * topk_mask


def compute_max_iou_anchor(ious: torch.Tensor) -> torch.Tensor:
    """[B, n, L] 0/1: for each anchor, the gt of largest IoU (the first on ties)."""
    max_idx = ious.argmax(dim=-2, keepdim=True)  # [B, 1, L]
    return torch.zeros_like(ious).scatter_(-2, max_idx, 1.0)


def _gather_assigned(mask_positive: torch.Tensor, gt_labels: torch.Tensor, gt_bboxes: torch.Tensor, num_classes: int):
    """Shared tail of both assigners: the gt of each anchor, its label, box and one-hot score."""
    mask_positive_sum = mask_positive.sum(dim=-2)  # [B, L]
    assigned_gt_index = mask_positive.argmax(dim=-2)  # [B, L], first max
    assigned_labels = torch.gather(gt_labels, 1, assigned_gt_index)
    assigned_labels = torch.where(mask_positive_sum > 0, assigned_labels, torch.full_like(assigned_labels, num_classes))
    assigned_bboxes = torch.gather(gt_bboxes, 1, assigned_gt_index[..., None].expand(-1, -1, 4))  # [B, L, 4]
    one_hot = torch.zeros((*assigned_labels.shape, num_classes + 1), dtype=gt_bboxes.dtype, device=gt_bboxes.device)
    assigned_scores = one_hot.scatter_(-1, assigned_labels[..., None], 1.0)[..., :num_classes]
    return assigned_labels, assigned_bboxes, assigned_scores, assigned_gt_index


def _resolve_multiple(mask_positive: torch.Tensor, ious: torch.Tensor) -> torch.Tensor:
    """An anchor matched to several gts keeps only its largest-IoU gt."""
    mask_multiple = mask_positive.sum(dim=-2, keepdim=True) > 1  # [B, 1, L]
    return torch.where(mask_multiple, compute_max_iou_anchor(ious), mask_positive)


class AssignResult(NamedTuple):
    labels: torch.Tensor  # [B, L] int64 (num_classes = background)
    bboxes: torch.Tensor  # [B, L, 4]
    scores: torch.Tensor  # [B, L, C]
    gt_index: torch.Tensor  # [B, L] index into the gt arrays (meaningful where fg)


class TaskAlignedAssigner:
    """TOOD task-aligned assignment, batched and masked."""

    def __init__(self, topk: int = 13, alpha: float = 1.0, beta: float = 6.0, eps: float = 1e-9):
        self.topk, self.alpha, self.beta, self.eps = topk, alpha, beta, eps

    @torch.no_grad()
    def __call__(
        self,
        pred_scores: torch.Tensor,  # [B, L, C] sigmoid scores
        pred_bboxes: torch.Tensor,  # [B, L, 4] pixels
        anchor_points: torch.Tensor,  # [L, 2] pixels
        gt_labels: torch.Tensor,  # [B, n] int64
        gt_bboxes: torch.Tensor,  # [B, n, 4]
        pad_gt_mask: torch.Tensor,  # [B, n] 1 = real box
        num_classes: int,
    ) -> AssignResult:
        pad = pad_gt_mask[..., None]
        ious = batch_iou_similarity(gt_bboxes, pred_bboxes) * pad  # [B, n, L]
        # each gt's class score at every anchor
        bbox_cls_scores = torch.gather(pred_scores.transpose(1, 2), 1, gt_labels[..., None].expand(-1, -1, ious.shape[-1]))

        alignment_metrics = flush_subnormals(bbox_cls_scores.pow(self.alpha) * ious.pow(self.beta))
        is_in_gts = check_points_inside_bboxes(anchor_points, gt_bboxes)
        is_in_topk = gather_topk_anchors(alignment_metrics * is_in_gts, self.topk, topk_mask=pad)
        mask_positive = _resolve_multiple(is_in_topk * is_in_gts * pad, ious)

        labels, bboxes, scores, gt_index = _gather_assigned(mask_positive, gt_labels, gt_bboxes, num_classes)

        # one-hot scores rescaled by the alignment metric, normalized per gt
        alignment_metrics = alignment_metrics * mask_positive
        max_metrics_per_instance = alignment_metrics.amax(dim=-1, keepdim=True)
        max_ious_per_instance = (ious * mask_positive).amax(dim=-1, keepdim=True)
        alignment_metrics = alignment_metrics / (max_metrics_per_instance + self.eps) * max_ious_per_instance
        scores = scores * alignment_metrics.amax(dim=-2)[..., None]
        return AssignResult(labels, bboxes, scores, gt_index)


class ATSSAssigner:
    """Adaptive Training Sample Selection, batched."""

    def __init__(self, topk: int = 9, eps: float = 1e-9):
        self.topk, self.eps = topk, eps

    @torch.no_grad()
    def __call__(
        self,
        anchor_bboxes: torch.Tensor,  # [L, 4] grid-cell boxes, pixels
        num_anchors_list: Sequence[int],
        gt_labels: torch.Tensor,  # [B, n]
        gt_bboxes: torch.Tensor,  # [B, n, 4]
        pad_gt_mask: torch.Tensor,  # [B, n]
        num_classes: int,
        pred_bboxes: Optional[torch.Tensor] = None,  # [B, L, 4], for IoU-weighted scores
    ) -> AssignResult:
        pad = pad_gt_mask[..., None]
        ious = batch_iou_similarity(gt_bboxes, anchor_bboxes[None].expand(gt_bboxes.shape[0], -1, -1)) * pad

        gt_centers = torch.stack(
            [(gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5, (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5], -1
        )  # [B, n, 2]
        anchor_centers = torch.stack(
            [(anchor_bboxes[:, 0] + anchor_bboxes[:, 2]) * 0.5, (anchor_bboxes[:, 1] + anchor_bboxes[:, 3]) * 0.5], -1
        )  # [L, 2]
        delta = gt_centers[:, :, None, :] - anchor_centers[None, None]  # [B, n, L, 2]
        dist = torch.sqrt(delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1])

        # per pyramid level, the topk closest anchors (nearest first, lowest index on ties)
        is_in_topk = torch.zeros_like(ious)
        candidates = []
        start = 0
        for la in num_anchors_list:
            k = min(self.topk, la)
            idx = _sorted_indices(dist[..., start : start + la], descending=False)[..., :k] + start
            is_in_topk.scatter_(-1, idx, 1.0)
            candidates.append(idx)
            start += la
        is_in_topk = is_in_topk * pad

        # mean + std (ddof 1) of the candidates' IoUs is each gt's threshold; the
        # candidates' IoUs are gathered, not selected by a [B, n, K, L] one-hot product
        iou_candidates = ious * is_in_topk
        cand_ious = torch.gather(iou_candidates, -1, torch.cat(candidates, dim=-1))  # [B, n, K_total]
        thr = cand_ious.mean(dim=-1, keepdim=True) + cand_ious.std(dim=-1, keepdim=True, correction=1)
        is_in_topk = torch.where(iou_candidates > thr, is_in_topk, torch.zeros_like(is_in_topk))

        is_in_gts = check_points_inside_bboxes(anchor_centers, gt_bboxes)
        mask_positive = _resolve_multiple(is_in_topk * is_in_gts * pad, ious)

        labels, bboxes, scores, gt_index = _gather_assigned(mask_positive, gt_labels, gt_bboxes, num_classes)
        if pred_bboxes is not None:
            pious = batch_iou_similarity(gt_bboxes, pred_bboxes) * mask_positive
            scores = scores * pious.amax(dim=-2)[..., None]
        return AssignResult(labels, bboxes, scores, gt_index)


# --------------------------------------------------------------------- losses


def giou_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """1 - GIoU, elementwise over [..., 4]."""
    x1, y1, x2, y2 = pred.unbind(-1)
    x1g, y1g, x2g, y2g = target.unbind(-1)
    xk1, yk1 = torch.maximum(x1, x1g), torch.maximum(y1, y1g)
    xk2, yk2 = torch.minimum(x2, x2g), torch.minimum(y2, y2g)
    overlap = (xk2 - xk1).clamp(min=0) * (yk2 - yk1).clamp(min=0)
    area1 = (x2 - x1) * (y2 - y1)
    area2 = (x2g - x1g) * (y2g - y1g)
    union = area1 + area2 - overlap + eps
    iou = overlap / union
    xc1, yc1 = torch.minimum(x1, x1g), torch.minimum(y1, y1g)
    xc2, yc2 = torch.maximum(x2, x2g), torch.maximum(y2, y2g)
    area_c = (xc2 - xc1) * (yc2 - yc1) + eps
    miou = iou - (area_c - union) / area_c
    return 1.0 - miou


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The JAX module's formula, term for term (not ``F.binary_cross_entropy_with_logits``)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def varifocal_loss(pred_logits, gt_score, label, alpha: float = 0.75, gamma: float = 2.0) -> torch.Tensor:
    """Sum-reduced varifocal loss."""
    pred_score = torch.sigmoid(pred_logits)
    weight = alpha * pred_score.pow(gamma) * (1 - label) + gt_score * label
    return torch.sum(weight * _bce_with_logits(pred_logits, gt_score))


def focal_loss(pred_logits, label, alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sum-reduced focal loss."""
    pred_score = torch.sigmoid(pred_logits)
    weight = (pred_score - label).abs().pow(gamma)
    if alpha > 0:
        weight = weight * (alpha * label + (1 - alpha) * (1 - label))
    return torch.sum(weight * _bce_with_logits(pred_logits, label))


def df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss, a two-hot cross entropy.

    pred_dist: [..., 4, reg_max+1] logits; target: [..., 4] in [0, reg_max).
    Returns [...], the mean over the 4 sides.
    """
    target_left = target.floor().long()
    target_right = target_left + 1
    weight_left = target_right.to(target.dtype) - target
    weight_right = 1.0 - weight_left
    logp = F.log_softmax(pred_dist, dim=-1)
    nbins = pred_dist.shape[-1]
    loss_left = -torch.gather(logp, -1, target_left[..., None])[..., 0] * weight_left
    loss_right = -torch.gather(logp, -1, target_right.clamp(0, nbins - 1)[..., None])[..., 0] * weight_right
    return (loss_left + loss_right).mean(dim=-1)


# ----------------------------------------------------------------- main loss


def _at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """fp32 for narrower floats; fp64 stays fp64 (the tests' fp64 reference runs)."""
    return t if t.dtype == torch.float64 else t.float()


@register_loss("PPYoloELoss")
class PPYoloELoss:
    """Varifocal (or focal) classification + GIoU + DFL, each normalized by the sum
    of the assigned scores (at least 1).

    ``loss(outputs, targets)`` takes the model's ``YoloNASOutputs`` (fp32) and
    targets ``[B, max_boxes, 5 or 6]``; returns ``(loss, {"loss_cls", "loss_iou",
    "loss_dfl"})``.
    """

    component_names = ["PPYoloELoss/loss_cls", "PPYoloELoss/loss_iou", "PPYoloELoss/loss_dfl", "PPYoloELoss/loss"]

    def __init__(
        self,
        num_classes: int,
        use_varifocal_loss: bool = True,
        use_static_assigner: bool = False,
        classification_loss_weight: float = 1.0,
        iou_loss_weight: float = 2.5,
        dfl_loss_weight: float = 0.5,
        grid_cell_scale: float = 5.0,
    ):
        self.num_classes = num_classes
        self.use_varifocal_loss = use_varifocal_loss
        self.use_static_assigner = use_static_assigner
        self.classification_loss_weight = classification_loss_weight
        self.iou_loss_weight = iou_loss_weight
        self.dfl_loss_weight = dfl_loss_weight
        self.grid_cell_scale = grid_cell_scale
        self.assigner = TaskAlignedAssigner(topk=13, alpha=1.0, beta=6.0)
        self.static_assigner = ATSSAssigner(topk=9)

    def assign(self, outputs, targets: torch.Tensor) -> AssignResult:
        """The assigner's labels, boxes and scores for these outputs (no gradient)."""
        return self._decode_and_assign(outputs, targets)[-1]

    def _decode_and_assign(self, outputs, targets: torch.Tensor):
        cls_logits, reg_distri = outputs.cls_logits, outputs.reg_distri
        points_s, stride_t = outputs.anchor_points, outputs.stride_tensor  # stride units, [L, 1]
        b, num_anchors, _ = cls_logits.shape
        reg_max = reg_distri.shape[-1] // 4 - 1

        gt_labels = targets[..., 0].clamp(min=0).long()
        gt_bboxes = targets[..., 1:5]
        pad_gt_mask = (targets[..., 0] >= 0).to(cls_logits.dtype)
        if targets.shape[-1] >= 6:  # crowd regions take no part in assignment or loss
            pad_gt_mask = pad_gt_mask * (targets[..., 5] <= 0).to(cls_logits.dtype)

        # predicted boxes in stride units; the gradient flows through them into the IoU loss
        pred_dist_4 = reg_distri.reshape(b, num_anchors, 4, reg_max + 1)
        pred_bboxes_s = batch_distance2bbox(points_s, dfl_decode(pred_dist_4, reg_max))
        points_px = points_s * stride_t
        pred_bboxes_px = pred_bboxes_s.detach() * stride_t[None]

        if self.use_static_assigner:
            half = (self.grid_cell_scale * stride_t[:, 0] * 0.5)[:, None]
            anchor_bboxes = torch.cat([points_px - half, points_px + half], -1)
            assign = self.static_assigner(
                anchor_bboxes=anchor_bboxes, num_anchors_list=outputs.num_anchors_list, gt_labels=gt_labels,
                gt_bboxes=gt_bboxes, pad_gt_mask=pad_gt_mask, num_classes=self.num_classes, pred_bboxes=pred_bboxes_px,
            )
        else:
            assign = self.assigner(
                pred_scores=torch.sigmoid(_at_least_f32(cls_logits.detach())), pred_bboxes=pred_bboxes_px,
                anchor_points=points_px, gt_labels=gt_labels, gt_bboxes=gt_bboxes, pad_gt_mask=pad_gt_mask,
                num_classes=self.num_classes,
            )
        return pred_dist_4, pred_bboxes_s, reg_max, assign

    def __call__(self, outputs, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pred_dist_4, pred_bboxes_s, reg_max, assign = self._decode_and_assign(outputs, targets)
        cls_logits = _at_least_f32(outputs.cls_logits)
        points_s, stride_t = outputs.anchor_points, outputs.stride_tensor

        if self.use_varifocal_loss:
            one_hot_label = F.one_hot(assign.labels, self.num_classes + 1)[..., :-1].to(assign.scores.dtype)
            cls_loss_sum = varifocal_loss(cls_logits, assign.scores, one_hot_label)
        else:
            cls_loss_sum = focal_loss(cls_logits, assign.scores, 0.25 if self.use_static_assigner else -1.0)

        # the global batch's sum, clamped as JAX clamps it, shared out over the ranks
        assigned_scores_sum = global_normalizer(assign.scores.sum())

        # box losses on the positives, masked (not gathered)
        mask_positive = (assign.labels != self.num_classes).to(assign.scores.dtype)  # [B, L]
        bbox_weight = assign.scores.sum(-1) * mask_positive
        assigned_bboxes_s = assign.bboxes / stride_t[None]

        iou_loss_sum = torch.sum(giou_loss(pred_bboxes_s, assigned_bboxes_s) * bbox_weight)
        assigned_ltrb = torch.cat([points_s - assigned_bboxes_s[..., :2], assigned_bboxes_s[..., 2:] - points_s], -1)
        assigned_ltrb = assigned_ltrb.clamp(0, reg_max - 0.01)
        dfl_loss_sum = torch.sum(df_loss(_at_least_f32(pred_dist_4), assigned_ltrb) * bbox_weight)

        cls_loss = self.classification_loss_weight * cls_loss_sum / assigned_scores_sum
        iou_loss = self.iou_loss_weight * iou_loss_sum / assigned_scores_sum
        dfl_loss = self.dfl_loss_weight * dfl_loss_sum / assigned_scores_sum
        loss = cls_loss + iou_loss + dfl_loss
        return loss, {"loss_cls": cls_loss, "loss_iou": iou_loss, "loss_dfl": dfl_loss}
