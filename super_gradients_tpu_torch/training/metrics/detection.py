"""Detection mAP metrics (counterpart of ``super_gradients_tpu/training/metrics/detection.py``).

The numpy matching engine (``_np_iou`` .. ``best_score_thresholds``) is a copy of
the JAX package's, line for line, so that both compute the same numbers from the
same NMS outputs. ``DetectionMetrics.preprocess_device`` runs ``ops.nms.batched_nms``
on the model's device: with ``nms_mode="exact"`` on a CUDA model that is kernel K1,
once per validation batch. The NMS output then goes to the host, where greedy IoU
matching and AP accumulation run in numpy. Under a process group each rank matches its
slice of the data and ``compute`` gathers every rank's matches in the one-process order.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from super_gradients_tpu_torch.common.environment import process_group_active
from super_gradients_tpu_torch.common.registry import register_metric
from super_gradients_tpu_torch.parallel.collectives import all_gather_per_rank, sum_across_processes
from super_gradients_tpu_torch.training.metrics.base import Metric


def _np_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def _np_ioa(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection over the area of ``a`` (ref detection_utils.py:797 crowd_ioa)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    return inter / (area_a[:, None] + 1e-9)


def match_predictions_to_gt(
    pred_boxes: np.ndarray,  # [P, 4] xyxy, sorted by score desc
    pred_labels: np.ndarray,  # [P]
    gt_boxes: np.ndarray,  # [G, 4]
    gt_labels: np.ndarray,  # [G]
    iou_thresholds: np.ndarray,  # [T]
    crowd_boxes: Optional[np.ndarray] = None,  # [Gc, 4]
    crowd_labels: Optional[np.ndarray] = None,  # [Gc]
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy per-threshold matching (higher-scored pred wins each gt).

    Returns (tp [P, T] bool, keep [P, T] bool). Same algorithm as the reference's
    IoUMatching (detection_utils.py:880+): candidate pairs (same class, IoU >= t)
    are ranked by IoU and greedily assigned so each gt and each pred match at most
    once. Crowd handling (detection_utils.py:797): an UNMATCHED prediction whose
    IoA with a same-class crowd gt exceeds the threshold is EXCLUDED from scoring
    (keep=False — neither TP nor FP), matching pycocotools' iscrowd semantics.
    """
    p, g = len(pred_boxes), len(gt_boxes)
    t = len(iou_thresholds)
    thr = np.asarray(iou_thresholds)
    tp = np.zeros((p, t), dtype=bool)
    keep = np.ones((p, t), dtype=bool)
    if p == 0:
        return tp, keep
    if g > 0:
        iou = _np_iou(pred_boxes, gt_boxes)
        same_cls = pred_labels[:, None] == gt_labels[None, :]
        iou = np.where(same_cls, iou, 0.0)
        # Matching priority is CONFIDENCE first, then IoU (ref IoUMatching
        # compute_targets, detection_utils.py:932-958): predictions arrive
        # confidence-sorted; each one claims its best still-free target per
        # threshold. (A global best-IoU-pair-first greedy gives DIFFERENT
        # matchings — a lower-confidence pred could steal a gt.) Thresholds
        # use the reference's STRICT ``iou > t``.
        gt_used = np.zeros((g, t), dtype=bool)
        min_thr = thr[0]
        for pi in range(p):
            row = iou[pi]
            for gi in np.argsort(-row, kind="stable"):
                v = row[gi]
                if v <= min_thr:
                    break
                good = (v > thr) & ~tp[pi] & ~gt_used[gi]
                tp[pi, good] = True
                gt_used[gi, good] = True
            if gt_used.all():
                break
    if crowd_boxes is not None and len(crowd_boxes) > 0:
        crowd_ioa = _np_ioa(pred_boxes, crowd_boxes)
        crowd_same = pred_labels[:, None] == crowd_labels[None, :]
        best_ioa = np.where(crowd_same, crowd_ioa, 0.0).max(axis=1)  # [P]
        # ignore unmatched preds with IoA strictly above the threshold
        # (ref compute_crowd_targets, detection_utils.py:1001)
        keep = tp | ~(best_ioa[:, None] > thr[None, :])
    return tp, keep


def match_predictions_to_gt_distance(
    pred_boxes: np.ndarray,
    pred_labels: np.ndarray,
    gt_boxes: np.ndarray,
    gt_labels: np.ndarray,
    distance_thresholds: np.ndarray,  # [T] pixels
) -> Tuple[np.ndarray, np.ndarray]:
    """Center-distance matching (ref DetectionMetricsDistanceBased /
    DistanceMatching, detection_utils.py:1008): candidate pairs are same-class
    with center distance <= t, greedily assigned smallest-distance-first."""
    p, g = len(pred_boxes), len(gt_boxes)
    t = len(distance_thresholds)
    thr = np.asarray(distance_thresholds)
    tp = np.zeros((p, t), dtype=bool)
    keep = np.ones((p, t), dtype=bool)
    if p == 0 or g == 0:
        return tp, keep
    pc = (pred_boxes[:, :2] + pred_boxes[:, 2:]) / 2
    gc = (gt_boxes[:, :2] + gt_boxes[:, 2:]) / 2
    dist = np.linalg.norm(pc[:, None] - gc[None, :], axis=-1)
    same_cls = pred_labels[:, None] == gt_labels[None, :]
    dist = np.where(same_cls, dist, np.inf)
    # confidence-first greedy, targets by ascending distance, STRICT `< t`
    # (ref DistanceMatching compute_targets, detection_utils.py:1060-1090 —
    # same structure as IoUMatching: preds arrive confidence-sorted)
    gt_used = np.zeros((g, t), dtype=bool)
    max_thr = thr.max()
    for pi in range(p):
        row = dist[pi]
        for gi in np.argsort(row, kind="stable"):
            v = row[gi]
            if v >= max_thr:
                break
            good = (v < thr) & ~tp[pi] & ~gt_used[gi]
            tp[pi, good] = True
            gt_used[gi, good] = True
        if gt_used.all():
            break
    return tp, keep


def compute_ap(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    n_gt_per_class: np.ndarray,
    keep: Optional[np.ndarray] = None,
    score_threshold: float = 0.1,
) -> Tuple:
    """Per-class AP with 101-point interpolation — number-for-number the
    reference's ``compute_detection_metrics_per_cls`` (detection_utils.py:1450-1600):

    - precision envelope (reversed cummax) BEFORE both reporting and AP sampling,
    - reported precision/recall are the rolling values at the last prediction
      with score >= ``score_threshold`` (0 when none is above it),
    - AP = mean of envelope precision sampled at 101 recall points
      (0 beyond max recall).

    tp: [N, T]; conf: [N]; pred_cls: [N]; n_gt_per_class: [C]; keep: [N, T]
    (crowd-excluded predictions are False and counted as neither TP nor FP —
    equivalent to the reference's preds_to_ignore rows, which contribute to
    neither cumsum).
    Returns (ap [C, T], precision [C, T], recall [C, T], f1 [C, T], classes_with_gt [C]).
    """
    num_classes = len(n_gt_per_class)
    tp = np.asarray(tp, dtype=bool)
    t = tp.shape[1] if tp.ndim == 2 else 1
    keep = np.ones_like(tp, dtype=bool) if keep is None else np.asarray(keep, dtype=bool)
    ap = np.zeros((num_classes, t))
    precision = np.zeros((num_classes, t))
    recall = np.zeros((num_classes, t))

    order = np.argsort(-conf, kind="stable")
    tp, conf, pred_cls, keep = tp[order], conf[order], pred_cls[order], keep[order]
    recall_points = np.linspace(0, 1, 101)

    for c in range(num_classes):
        mask = pred_cls == c
        n_gt = n_gt_per_class[c]
        if n_gt == 0 or not mask.any():
            continue
        for ti in range(t):
            mk = mask & keep[:, ti]
            tpc = tp[mk, ti].cumsum()
            if len(tpc) == 0:
                continue
            fpc = (~tp[mk, ti]).cumsum()
            confc = conf[mk]
            rec = tpc / n_gt
            prec = tpc / (tpc + fpc + np.finfo(np.float64).eps)
            env = np.flip(np.maximum.accumulate(np.flip(prec)))
            # reported P/R at the score threshold (ref :1528-1537)
            idx = np.searchsorted(-confc, -score_threshold, side="right")
            if idx > 0:
                precision[c, ti] = env[idx - 1]
                recall[c, ti] = rec[idx - 1]
            # AP (ref :1560-1580): envelope padded with one trailing 0
            env_pad = np.concatenate([env, [0.0]])
            inds = np.searchsorted(rec, recall_points, side="left")
            ap[c, ti] = env_pad[inds].mean()
    f1 = 2 * precision * recall / (precision + recall + 1e-16)
    has_gt = n_gt_per_class > 0
    return ap, precision, recall, f1, has_gt


def best_score_threshold(
    tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, n_gt_per_class: np.ndarray, keep: Optional[np.ndarray] = None
) -> Tuple[float, float]:
    """Score threshold maximizing mean-class F1 at the first IoU threshold
    (ref detection_metrics.py:88 best_score_threshold). Returns (threshold, best_f1)."""
    thr, f1, _ = best_score_thresholds(tp, conf, pred_cls, n_gt_per_class, keep)
    return thr, f1


def best_score_thresholds(
    tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, n_gt_per_class: np.ndarray, keep: Optional[np.ndarray] = None
) -> Tuple[float, float, dict]:
    """Global AND per-class best-F1 score thresholds, exactly the reference's
    sweep (detection_utils.py:1540-1560 + :1441-1447): for each class, the
    ENVELOPE precision / rolling recall are sampled at 101 score thresholds and
    F1 is averaged over ALL IoU thresholds; the global threshold maximizes the
    class-mean of that curve. Returns
    (global_threshold, global_best_f1, {class_id: per_class_threshold}).

    NOTE on the grid: the reference's sweep is the FIXED grid
    ``torch.linspace(0, 1, nb_score_thrs)`` (detection_utils.py:1418 and :1561
    ``all_score_thresholds``), NOT the observed confidence values — the rolling
    P/R curves are indexed at each grid point via searchsorted over the sorted
    scores. Our 101-point ``np.linspace`` grid is therefore bit-identical in
    semantics; ``tests/test_detection_metrics_golden.py`` asserts the global and
    per-class thresholds against the reference's own code at 1e-6."""
    if len(conf) == 0:
        return 0.0, 0.0, {}
    tp = np.asarray(tp, dtype=bool)
    t = tp.shape[1] if tp.ndim == 2 else 1
    keep = np.ones_like(tp, dtype=bool) if keep is None else np.asarray(keep, dtype=bool)
    grid = np.linspace(0, 1, 101)
    order = np.argsort(-conf, kind="stable")
    tp, conf_s, cls_s, keep = tp[order], conf[order], pred_cls[order], keep[order]
    classes = [c for c in range(len(n_gt_per_class)) if n_gt_per_class[c] > 0]
    if not classes:
        return 0.0, 0.0, {}
    f1s = np.zeros((len(grid),))
    per_class: dict = {}
    for c in classes:
        mask = cls_s == c
        n_gt = n_gt_per_class[c]
        f1c = np.zeros((len(grid), t))
        for ti in range(t):
            mk = mask & keep[:, ti]
            tpc = tp[mk, ti].cumsum()
            if len(tpc) == 0:
                continue
            fpc = (~tp[mk, ti]).cumsum()
            confc = conf_s[mk]
            rec = tpc / n_gt
            prec = tpc / (tpc + fpc + np.finfo(np.float64).eps)
            env = np.flip(np.maximum.accumulate(np.flip(prec)))
            # index i with preds_scores[i-1] >= s > preds_scores[i]; 0 → no pred above s
            counts = np.searchsorted(-confc, -grid, side="right")
            rec_pad = np.concatenate([[0.0], rec])
            env_pad = np.concatenate([[0.0], env])
            r_at, p_at = rec_pad[counts], env_pad[counts]
            f1c[:, ti] = 2 * r_at * p_at / (r_at + p_at + 1e-16)
        f1c_mean = f1c.mean(axis=1)  # over IoU thresholds (ref :1558)
        per_class[int(c)] = float(grid[int(np.argmax(f1c_mean))])
        f1s += f1c_mean
    f1s /= len(classes)
    bi = int(np.argmax(f1s))
    return float(grid[bi]), float(f1s[bi]), per_class



def gather_in_batch_order(arrays: Dict[str, np.ndarray], rows: Sequence[int]) -> Dict[str, np.ndarray]:
    """Every rank's host metric rows in the one-process order: batch by batch, each batch's
    rank slices in rank order (rank r loads the r-th contiguous slice of every global
    batch). ``rows`` holds this rank's count of rows in each of its batches. The order
    matters where equal scores tie in the AP's stable sort."""
    parts = all_gather_per_rank(arrays)
    offsets = [np.concatenate([[0], np.cumsum(p["rows"])]) for p in all_gather_per_rank({"rows": np.asarray(rows, np.int64)})]
    pieces = {k: [a[:0]] for k, a in arrays.items()}
    for b in range(max(len(o) for o in offsets) - 1):
        for part, off in zip(parts, offsets):
            if b + 1 < len(off):
                for k in arrays:
                    pieces[k].append(part[k][off[b]:off[b + 1]])
    return {k: np.concatenate(v) for k, v in pieces.items()}


@register_metric("DetectionMetrics")
class DetectionMetrics(Metric):
    """mAP@[0.5:0.95] + P/R/F1@0.5 (ref DetectionMetrics, detection_metrics.py:28)."""

    host_update = True

    def __init__(
        self,
        num_cls: int = 80,
        iou_thresholds: Optional[Sequence[float]] = None,
        score_threshold: float = 0.01,
        nms_iou: float = 0.7,
        nms_top_k: int = 1024,
        max_predictions: int = 300,
        class_agnostic_nms: bool = False,
        multi_label_per_box: bool = True,
        nms_mode: str = "exact",
        score_thres: float = 0.1,  # metric-reporting threshold for P/R/F1 (ref DetectionMetrics score_thres)
        include_classwise_ap: bool = False,
        class_names: Optional[Sequence[str]] = None,
        calc_best_score_thresholds: bool = True,
        sync_on_compute: bool = True,
    ):
        self.num_cls = num_cls
        self.iou_thresholds = np.asarray(iou_thresholds if iou_thresholds is not None else np.linspace(0.5, 0.95, 10))
        self.score_threshold = score_threshold
        self.nms_iou = nms_iou
        self.nms_top_k = nms_top_k
        self.max_predictions = max_predictions
        self.class_agnostic_nms = class_agnostic_nms
        self.multi_label_per_box = multi_label_per_box
        self.nms_mode = nms_mode
        self.score_thres = score_thres
        self.include_classwise_ap = include_classwise_ap
        self.class_names = list(class_names) if class_names else None
        self.calc_best_score_thresholds = calc_best_score_thresholds
        self.sync_on_compute = sync_on_compute

    @property
    def _range_str(self) -> str:
        lo, hi = self.iou_thresholds[0], self.iou_thresholds[-1]
        return f"{lo:.2f}" if len(self.iou_thresholds) == 1 else f"{lo:.2f}:{hi:.2f}"

    def init(self):
        # rows: the detections each update added, which the gather across ranks orders by
        return {"tp": [], "conf": [], "cls": [], "keep": [], "n_gt": np.zeros(self.num_cls, dtype=np.int64),
                "rows": []}

    def _match(self, pb, pl, gb, gl, crowd_b, crowd_l):
        return match_predictions_to_gt(pb, pl, gb, gl, self.iou_thresholds, crowd_b, crowd_l)

    def preprocess_device(self, outputs, targets):
        """NMS of the decoded outputs on their device (K1 for ``nms_mode="exact"`` on a GPU)."""
        from super_gradients_tpu_torch.ops.nms import batched_nms

        return batched_nms(
            outputs.pred_bboxes,
            outputs.pred_scores,
            score_threshold=self.score_threshold,
            iou_threshold=self.nms_iou,
            nms_top_k=self.nms_top_k,
            max_predictions=self.max_predictions,
            multi_label=self.multi_label_per_box,
            class_agnostic=self.class_agnostic_nms,
            mode=self.nms_mode,
            prefilter="two_stage",
        )

    def update(self, state, nms_out, targets):
        """Host: greedy matching per image.

        targets: [B, max_boxes, 5] padded (cls, x1, y1, x2, y2), or
        [B, max_boxes, 6] with an is_crowd flag in column 5 — crowd gts are
        excluded from matching and unmatched predictions overlapping them (IoA >
        threshold) are dropped from scoring (ref detection_utils.py:797).
        """
        boxes = np.asarray(nms_out.boxes)
        scores = np.asarray(nms_out.scores)
        labels = np.asarray(nms_out.labels)
        nums = np.asarray(nms_out.num_detections)
        targets = np.asarray(targets)
        has_crowd_col = targets.shape[-1] >= 6
        rows = 0
        for i in range(boxes.shape[0]):
            n = int(nums[i])
            pb, ps, pl = boxes[i, :n], scores[i, :n], labels[i, :n]
            valid = targets[i, :, 0] >= 0
            is_crowd = (targets[i, :, 5] > 0) & valid if has_crowd_col else np.zeros_like(valid)
            reg = valid & ~is_crowd
            gb = targets[i, reg, 1:5]
            gl = targets[i, reg, 0].astype(np.int64)
            cb = targets[i, is_crowd, 1:5] if has_crowd_col else None
            cl = targets[i, is_crowd, 0].astype(np.int64) if has_crowd_col else None
            order = np.argsort(-ps, kind="stable")  # stable: equal scores keep NMS emission order (ref sorts in NMS)
            pb, ps, pl = pb[order], ps[order], pl[order]
            tp, keep = self._match(pb, pl, gb, gl, cb, cl)
            state["tp"].append(tp)
            state["conf"].append(ps)
            state["cls"].append(pl)
            state["keep"].append(keep)
            np.add.at(state["n_gt"], gl, 1)
            rows += len(tp)
        state["rows"].append(rows)
        return state

    def _gather_across_processes(self, state):
        """Every rank's matches, in the one-process order, and the summed ``n_gt``, so that
        every rank computes the global metric (JAX ``all_gather_variable_length``)."""
        if not self.sync_on_compute or not process_group_active():
            return state
        t = len(self.iou_thresholds)
        local = {
            "tp": np.concatenate(state["tp"]) if state["tp"] else np.zeros((0, t), bool),
            "keep": np.concatenate(state["keep"]) if state["keep"] else np.ones((0, t), bool),
            "conf": np.concatenate(state["conf"]).astype(np.float32) if state["conf"] else np.zeros((0,), np.float32),
            "cls": np.concatenate(state["cls"]).astype(np.int64) if state["cls"] else np.zeros((0,), np.int64),
        }
        gathered = gather_in_batch_order(local, state["rows"])
        return {**{k: [v] for k, v in gathered.items()}, "n_gt": sum_across_processes(state["n_gt"])}

    def compute(self, state) -> Dict[str, float]:
        rs = self._range_str
        state = self._gather_across_processes(state)
        empty = {f"mAP@{rs}": 0.0, f"Precision@{rs}": 0.0, f"Recall@{rs}": 0.0, f"F1@{rs}": 0.0}
        if not state["tp"]:
            return empty
        tp = np.concatenate(state["tp"])
        conf = np.concatenate(state["conf"])
        cls = np.concatenate(state["cls"])
        keep = np.concatenate(state["keep"]) if state.get("keep") else None
        ap, precision, recall, f1, has_gt = compute_ap(tp, conf, cls, state["n_gt"], keep, score_threshold=self.score_thres)
        if not has_gt.any():
            return empty
        out = {
            f"mAP@{rs}": float(ap[has_gt].mean()),
            f"Precision@{rs}": float(precision[has_gt, 0].mean()),
            f"Recall@{rs}": float(recall[has_gt, 0].mean()),
            f"F1@{rs}": float(f1[has_gt, 0].mean()),
        }
        if len(self.iou_thresholds) > 1:
            out[f"mAP@{self.iou_thresholds[0]:.2f}"] = float(ap[has_gt, 0].mean())
        if self.calc_best_score_thresholds:
            thr, bf1, per_cls = best_score_thresholds(tp, conf, cls, state["n_gt"], keep)
            out["Best_score_threshold"] = thr
            if self.include_classwise_ap:
                for c, t in per_cls.items():
                    name = self.class_names[c] if self.class_names and c < len(self.class_names) else str(c)
                    out[f"Best_score_threshold_{name}"] = t
        if self.include_classwise_ap:
            for c in np.nonzero(has_gt)[0]:
                name = self.class_names[c] if self.class_names and c < len(self.class_names) else str(c)
                out[f"AP@{rs}_{name}"] = float(ap[c].mean())
        return out


@register_metric("DetectionMetrics_050")
class DetectionMetrics_050(DetectionMetrics):
    def __init__(self, **kw):
        kw.pop("iou_thresholds", None)
        super().__init__(iou_thresholds=[0.5], **kw)


@register_metric("DetectionMetrics_075")
class DetectionMetrics_075(DetectionMetrics):
    def __init__(self, **kw):
        kw.pop("iou_thresholds", None)
        super().__init__(iou_thresholds=[0.75], **kw)


@register_metric("DetectionMetrics_050_095")
class DetectionMetrics_050_095(DetectionMetrics):
    pass


@register_metric("DetectionMetricsDistanceBased")
class DetectionMetricsDistanceBased(DetectionMetrics):
    """mAP with center-distance matching instead of IoU (ref
    detection_metrics.py:295 DetectionMetricsDistanceBased). ``distance_thresholds``
    are in pixels of the network input space."""

    def __init__(self, distance_thresholds: Sequence[float] = (5.0,), **kw):
        kw.pop("iou_thresholds", None)
        super().__init__(iou_thresholds=list(distance_thresholds), **kw)
        self.distance_thresholds = np.asarray(distance_thresholds, np.float32)

    @property
    def _range_str(self) -> str:
        lo, hi = self.distance_thresholds[0], self.distance_thresholds[-1]
        return f"dist{lo:g}" if len(self.distance_thresholds) == 1 else f"dist{lo:g}:{hi:g}"

    def _match(self, pb, pl, gb, gl, crowd_b, crowd_l):
        return match_predictions_to_gt_distance(pb, pl, gb, gl, self.distance_thresholds)
