"""Batched, class-aware, fixed-shape NMS (counterpart of ``super_gradients_tpu/ops/nms.py``).

``[B, N, C]`` score maps go through a top-k prefilter, the class-offset trick,
suppression and compaction into fixed ``[B, max_predictions]`` outputs with a
per-image count. Every step is written over the batch dimension; there is no
per-image Python loop. Suppression modes:

- ``exact`` / ``pallas`` — greedy NMS (torchvision semantics) through kernel K1,
  :func:`~super_gradients_tpu_torch.ops.kernels.nms_exact.exact_nms_keep`. The JAX
  package has two forms of it (an XLA loop and a Pallas kernel); here both names
  run the one kernel.
- ``fast`` — YOLACT fast NMS: suppressed if any higher-ranked box overlaps.
- ``matrix`` — Matrix-NMS (SOLOv2) gaussian score decay.

:func:`batched_pose_nms` is the single-class pose form: exact mode through K1, every
other mode fast NMS, as the JAX function.

Top-k everywhere is a stable descending sort, so ties go to the lowest index
first, as ``jax.lax.top_k`` does (``torch.topk`` does not promise that order).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from super_gradients_tpu_torch.ops.bbox import box_iou
from super_gradients_tpu_torch.ops.kernels.nms_exact import exact_nms_keep

_CLASS_OFFSET = 8192.0  # > any image dimension we support; separates classes spatially


class NMSOutput(NamedTuple):
    """Fixed-shape detection output."""

    boxes: torch.Tensor  # [B, max_predictions, 4] xyxy
    scores: torch.Tensor  # [B, max_predictions]
    labels: torch.Tensor  # [B, max_predictions] int32, -1 past num_detections
    num_detections: torch.Tensor  # [B] int32


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: descending, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _fast_keep_mask(iou: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """YOLACT fast NMS on ``[B, K, K]`` IoUs: keep i unless a higher-ranked j overlaps it."""
    idx = torch.arange(valid.shape[-1], device=valid.device)
    upper = idx[:, None] < idx[None, :]  # [j, i]: j ranked above i
    over = (iou > iou_threshold) & valid[:, None, :] & valid[:, :, None]
    return valid & ~(over & upper).any(dim=1)


def _matrix_nms_decay(iou: torch.Tensor, valid: torch.Tensor, sigma: float = 0.5) -> torch.Tensor:
    """Matrix-NMS gaussian decay factors ``[B, K]`` for score-sorted boxes."""
    idx = torch.arange(valid.shape[-1], device=valid.device)
    upper = (idx[:, None] < idx[None, :]) & valid[:, None, :] & valid[:, :, None]
    ious = torch.where(upper, iou, 0.0)  # [b, j, i]: iou of i with higher-ranked j
    ious_cmax = ious.max(dim=1).values  # [b, j]: most-overlapped compensation per j
    decay = torch.exp(-(ious**2 - ious_cmax[:, :, None] ** 2) / sigma)
    decay = torch.where(upper, decay, 1.0)
    return decay.min(dim=1).values


def _prefilter(scores, nms_top_k, multi_label, prefilter, class_top_k, scores_are_logits):
    """Top candidates of ``[B, N, C]`` scores -> (fp32 scores, anchor idx, class idx), each ``[B, K]``.

    Runs in the input dtype and casts only the gathered candidates to fp32
    (bf16 -> fp32 is exact and monotone, so the same elements are picked).
    """
    b, n, c = scores.shape
    to_score = torch.sigmoid if scores_are_logits else (lambda v: v)
    if multi_label and prefilter == "two_stage" and n > nms_top_k:
        # top anchors by per-anchor max, then a flat top-k over each one's best
        # `class_top_k` classes (see the JAX module for why this is exact)
        k = min(nms_top_k, n)
        _, aidx = _top_k(scores.max(dim=-1).values, k)  # [B, k]
        sub = to_score(torch.gather(scores, 1, aidx[:, :, None].expand(b, k, c)).float())  # [B, k, C]
        t = min(class_top_k, c)
        vals, cls_of_t = _top_k(sub, t)  # [B, k, T]
        top_scores, sidx = _top_k(vals.reshape(b, k * t), k)
        anchor_idx = torch.gather(aidx, 1, torch.div(sidx, t, rounding_mode="floor"))
        cls_idx = torch.gather(cls_of_t.reshape(b, k * t), 1, sidx)
    elif multi_label:
        k = min(nms_top_k, n * c)
        top_scores, top_idx = _top_k(scores.reshape(b, n * c), k)
        top_scores = to_score(top_scores.float())
        anchor_idx = torch.div(top_idx, c, rounding_mode="floor")
        cls_idx = top_idx % c
    else:
        best, cls_all = scores.max(dim=-1)
        # torch.max on CPU and CUDA returns the first maximal index, as jnp.argmax
        k = min(nms_top_k, n)
        top_scores, anchor_idx = _top_k(best, k)
        top_scores = to_score(top_scores.float())
        cls_idx = torch.gather(cls_all, 1, anchor_idx)
    return top_scores, anchor_idx, cls_idx


def batched_nms(
    boxes: torch.Tensor,  # [B, N, 4] xyxy
    scores: torch.Tensor,  # [B, N, C] (post-sigmoid, or logits with scores_are_logits)
    score_threshold: float = 0.25,
    iou_threshold: float = 0.7,
    nms_top_k: int = 1024,
    max_predictions: int = 300,
    multi_label: bool = True,
    class_agnostic: bool = False,
    mode: str = "exact",
    prefilter: str = "two_stage",
    class_top_k: int = 4,
    scores_are_logits: bool = False,
) -> NMSOutput:
    """Batched class-aware NMS with fixed output shapes.

    ``prefilter``: "two_stage" (per-anchor ``class_top_k`` candidate selection)
    or "flat" (one top-k over N*C). ``scores_are_logits``: ``scores`` holds
    pre-sigmoid logits; the sigmoid is applied to the gathered candidates only,
    ``score_threshold`` stays in probability space.
    """
    if mode not in ("exact", "pallas", "fast", "matrix"):
        raise ValueError(f"Unknown NMS mode `{mode}` (exact|fast|matrix|pallas)")
    top_scores, anchor_idx, cls_idx = _prefilter(scores, nms_top_k, multi_label, prefilter, class_top_k, scores_are_logits)
    b, k = top_scores.shape
    cand_boxes = torch.gather(boxes, 1, anchor_idx[:, :, None].expand(b, k, 4)).float()  # [B, K, 4]
    valid = top_scores > score_threshold

    if class_agnostic:
        nms_boxes = cand_boxes
    else:
        nms_boxes = cand_boxes + (cls_idx.float() * _CLASS_OFFSET)[:, :, None]

    m = min(max_predictions, k)
    if mode == "matrix":
        decayed = top_scores * _matrix_nms_decay(box_iou(nms_boxes, nms_boxes), valid)
        keep = valid & (decayed > score_threshold)
        # decayed scores are re-ordered -> a real sort
        out_scores, out_idx = _top_k(torch.where(keep, decayed, -1.0), m)
        out_boxes = torch.gather(cand_boxes, 1, out_idx[:, :, None].expand(b, m, 4))
        out_labels = torch.gather(cls_idx, 1, out_idx).int()
        valid_out = out_scores > 0
        out_scores = torch.where(valid_out, out_scores, 0.0)
    else:
        if mode == "fast":
            keep = _fast_keep_mask(box_iou(nms_boxes, nms_boxes), valid, iou_threshold)
        else:
            keep = exact_nms_keep(nms_boxes.contiguous(), valid, iou_threshold)
        # candidates are score-sorted, so the kept ones are too: scatter each kept
        # candidate to its rank among the kept; slot m collects the rest
        pos = torch.cumsum(keep.int(), dim=1) - 1
        slot = torch.where(keep & (pos < m), pos, m).long()
        out_boxes = cand_boxes.new_zeros(b, m + 1, 4).scatter_(1, slot[:, :, None].expand(b, k, 4), cand_boxes)[:, :m]
        out_scores = top_scores.new_zeros(b, m + 1).scatter_(1, slot, top_scores)[:, :m]
        out_labels = cls_idx.new_zeros(b, m + 1).scatter_(1, slot, cls_idx)[:, :m].int()
        valid_out = torch.arange(m, device=keep.device)[None, :] < keep.sum(dim=1, keepdim=True)
    out_boxes = torch.where(valid_out[:, :, None], out_boxes, 0.0)
    out_labels = torch.where(valid_out, out_labels, -1)
    num = valid_out.sum(dim=1, dtype=torch.int32)
    if m < max_predictions:  # pad to the requested static size
        pad = max_predictions - m
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_labels = torch.nn.functional.pad(out_labels, (0, pad), value=-1)
    return NMSOutput(out_boxes, out_scores, out_labels, num)


class PoseNMSOutput(NamedTuple):
    """Fixed-shape pose output."""

    poses: torch.Tensor  # [B, max_predictions, J, 3] (x, y, joint score)
    boxes: torch.Tensor  # [B, max_predictions, 4] xyxy
    scores: torch.Tensor  # [B, max_predictions]
    num_detections: torch.Tensor  # [B] int32


def batched_pose_nms(
    boxes: torch.Tensor,  # [B, A, 4] xyxy
    scores: torch.Tensor,  # [B, A] or [B, A, 1]
    pose_coords: torch.Tensor,  # [B, A, J, 2]
    pose_scores: torch.Tensor,  # [B, A, J]
    score_threshold: float = 0.1,
    iou_threshold: float = 0.7,
    nms_top_k: int = 1024,
    max_predictions: int = 30,
    mode: str = "exact",
) -> PoseNMSOutput:
    """Single-class NMS carrying each anchor's keypoints.

    The top ``nms_top_k`` anchors by score, in fp32, go through suppression:
    ``mode="exact"`` is greedy NMS through kernel K1 (no class offset); every other
    mode, ``"pallas"`` included, is fast NMS, as in the JAX function. The kept
    candidates are compacted by a second top-k of the scores with the suppressed ones
    at -1 (both top-k stable: ties to the lowest index, as ``jax.lax.top_k``).
    """
    if scores.dim() == 3:
        scores = scores[..., 0]
    b, a = scores.shape
    j = pose_coords.shape[2]
    k = min(nms_top_k, a)
    top_scores, aidx = _top_k(scores, k)
    top_scores = top_scores.float()
    cand_boxes = torch.gather(boxes, 1, aidx[:, :, None].expand(b, k, 4)).float()
    cand_poses = torch.cat([
        torch.gather(pose_coords, 1, aidx[:, :, None, None].expand(b, k, j, 2)).float(),
        torch.gather(pose_scores, 1, aidx[:, :, None].expand(b, k, j)).float()[..., None],
    ], dim=-1)  # [B, K, J, 3]
    valid = top_scores > score_threshold

    if mode == "exact":
        keep = exact_nms_keep(cand_boxes.contiguous(), valid, iou_threshold)
    else:
        keep = _fast_keep_mask(box_iou(cand_boxes, cand_boxes), valid, iou_threshold)

    m = min(max_predictions, k)
    out_scores, oidx = _top_k(torch.where(keep, top_scores, -1.0), m)
    out_boxes = torch.gather(cand_boxes, 1, oidx[:, :, None].expand(b, m, 4))
    out_poses = torch.gather(cand_poses, 1, oidx[:, :, None, None].expand(b, m, j, 3))
    valid_out = out_scores > 0
    out_scores = torch.where(valid_out, out_scores, 0.0)
    out_boxes = torch.where(valid_out[:, :, None], out_boxes, 0.0)
    out_poses = torch.where(valid_out[:, :, None, None], out_poses, 0.0)
    num = valid_out.sum(dim=1, dtype=torch.int32)
    if m < max_predictions:  # pad to the requested static size
        pad = max_predictions - m
        out_poses = torch.nn.functional.pad(out_poses, (0, 0, 0, 0, 0, pad))
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
    return PoseNMSOutput(out_poses, out_boxes, out_scores, num)
