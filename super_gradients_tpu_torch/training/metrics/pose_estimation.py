"""Pose estimation metrics: COCO-style OKS AP / AR (counterpart of
``super_gradients_tpu/training/metrics/pose_estimation.py``).

``PoseEstimationMetrics.preprocess_device`` runs ``ops.nms.batched_pose_nms`` on the
model's device: with ``nms_mode="exact"`` on a CUDA model that is kernel K1, once per
validation batch. The NMS output then goes to the host, where the greedy OKS matching
at the thresholds 0.5:0.95 and the AP accumulation (the detection metrics'
``compute_ap``) run in numpy, line for line as in the JAX package. Under a process group
``compute`` gathers every rank's matches in the one-process order, as ``DetectionMetrics`` does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from super_gradients_tpu_torch.common.environment import process_group_active
from super_gradients_tpu_torch.common.registry import register_metric
from super_gradients_tpu_torch.models.class_names import COCO_POSE_SIGMAS
from super_gradients_tpu_torch.ops.nms import batched_pose_nms
from super_gradients_tpu_torch.training.metrics.base import Metric
from super_gradients_tpu_torch.parallel.collectives import sum_across_processes
from super_gradients_tpu_torch.training.metrics.detection import compute_ap, gather_in_batch_order


def oks_matrix(pred_poses: np.ndarray, gt_poses: np.ndarray, gt_areas: np.ndarray, sigmas: np.ndarray) -> np.ndarray:
    """``[P, J, >=2]`` x ``[G, J, 3]`` -> ``[P, G]`` OKS (0 for a gt without a visible joint)."""
    p, g = len(pred_poses), len(gt_poses)
    if p == 0 or g == 0:
        return np.zeros((p, g))
    d = ((pred_poses[:, None, :, :2] - gt_poses[None, :, :, :2]) ** 2).sum(-1)  # [P, G, J]
    vis = gt_poses[None, :, :, 2] > 0
    e = d / (2 * sigmas.reshape(1, 1, -1)) ** 2 / (gt_areas.reshape(1, -1, 1) + 1e-9) / 2
    oks = np.exp(-e)
    nv = vis.sum(-1)
    return np.where(nv > 0, (oks * vis).sum(-1) / np.maximum(nv, 1), 0.0)


@register_metric("PoseEstimationMetrics")
class PoseEstimationMetrics(Metric):
    """AP and AR at OKS 0.5:0.95 over the validation set; targets ``[B, max_poses, 5 + 3J]``."""

    host_update = True

    def __init__(
        self,
        num_joints: int = 17,
        oks_sigmas: Optional[Sequence[float]] = None,
        iou_thresholds: Optional[Sequence[float]] = None,
        post_prediction_conf: float = 0.01,
        nms_iou: float = 0.7,
        max_predictions: int = 30,
        nms_mode: str = "exact",
    ):
        self.num_joints = num_joints
        self.sigmas = np.asarray(oks_sigmas if oks_sigmas is not None else COCO_POSE_SIGMAS[:num_joints])
        self.thresholds = np.asarray(iou_thresholds if iou_thresholds is not None else np.linspace(0.5, 0.95, 10))
        self.conf = post_prediction_conf
        self.nms_iou = nms_iou
        self.max_predictions = max_predictions
        self.nms_mode = nms_mode

    def init(self):
        return {"tp": [], "conf": [], "n_gt": 0, "rows": []}

    def preprocess_device(self, outputs, targets):
        return batched_pose_nms(
            outputs.pred_bboxes, outputs.pred_scores, outputs.pred_pose_coords, outputs.pred_pose_scores,
            score_threshold=self.conf, iou_threshold=self.nms_iou, max_predictions=self.max_predictions,
            mode=self.nms_mode,
        )

    def update(self, state, nms_out, targets):
        """nms_out: the host copy of :meth:`preprocess_device`'s ``PoseNMSOutput``."""
        poses = np.asarray(nms_out.poses)
        scores = np.asarray(nms_out.scores)
        nums = np.asarray(nms_out.num_detections)
        targets = np.asarray(targets)
        k = self.num_joints
        rows = 0
        for i in range(poses.shape[0]):
            n = int(nums[i])
            valid_gt = targets[i, :, 0] >= 0
            gt_boxes = targets[i, valid_gt, 1:5]
            gt_poses = targets[i, valid_gt, 5 : 5 + 3 * k].reshape(-1, k, 3)
            gt_areas = np.clip(gt_boxes[:, 2] - gt_boxes[:, 0], 0, None) * np.clip(gt_boxes[:, 3] - gt_boxes[:, 1], 0, None)
            state["n_gt"] += int(valid_gt.sum())
            if n == 0:
                continue
            order = np.argsort(-scores[i, :n])
            pp = poses[i, :n][order]
            oks = oks_matrix(pp, gt_poses, gt_areas, self.sigmas)
            t = len(self.thresholds)
            tp = np.zeros((n, t), bool)
            for ti, thr in enumerate(self.thresholds):
                cand_p, cand_g = np.nonzero(oks >= thr)
                if len(cand_p) == 0:
                    continue
                o2 = np.argsort(-oks[cand_p, cand_g])
                used_p = np.zeros(n, bool)
                used_g = np.zeros(len(gt_poses), bool)
                for kk in o2:
                    pi, gi = cand_p[kk], cand_g[kk]
                    if not used_p[pi] and not used_g[gi]:
                        used_p[pi] = used_g[gi] = True
                        tp[pi, ti] = True
            state["tp"].append(tp)
            state["conf"].append(scores[i, :n][order])
            rows += n
        state["rows"].append(rows)
        return state

    def _gather_across_processes(self, state):
        """Every rank's matches in the one-process order and the summed ``n_gt``."""
        if not process_group_active():
            return state
        t = len(self.thresholds)
        local = {"tp": np.concatenate(state["tp"]) if state["tp"] else np.zeros((0, t), bool),
                 "conf": (np.concatenate(state["conf"]) if state["conf"] else np.zeros((0,))).astype(np.float64)}
        gathered = gather_in_batch_order(local, state["rows"])
        return {"tp": [gathered["tp"]], "conf": [gathered["conf"]], "n_gt": sum_across_processes(state["n_gt"])}

    def compute(self, state) -> Dict[str, float]:
        state = self._gather_across_processes(state)
        if not state["tp"] or state["n_gt"] == 0:
            return {"AP": 0.0, "AR": 0.0}
        tp = np.concatenate(state["tp"])
        conf = np.concatenate(state["conf"])
        cls = np.zeros(len(conf), dtype=np.int64)  # one class: person
        n_gt = np.asarray([state["n_gt"]])
        ap, precision, recall, f1, has_gt = compute_ap(tp, conf, cls, n_gt)
        return {"AP": float(ap[0].mean()), "AR": float(recall[0].mean())}
