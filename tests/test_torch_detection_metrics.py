"""The port's detection metrics against the JAX package's, on the CPU.

The numpy matching engine is a copy of the JAX one, so on identical inputs every
result must be EXACTLY equal (``np.array_equal``, and ``==`` on the floats of
``compute()``): IoU / IoA, the greedy matching (with crowd rows), the distance
matching, ``compute_ap`` and the best score thresholds. ``DetectionMetrics`` and
its variants are fed the same NMS outputs and targets over several batches.
``preprocess_device`` runs each side's ``batched_nms`` (the port's plain K1
version, the JAX exact loop) on the same outputs: counts, labels and scores
equal, boxes equal (both gather the same fp32 inputs).
"""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.training.metrics import detection as jax_det
from super_gradients_tpu.training.metrics import get_metric as jax_get_metric
from super_gradients_tpu_torch.common.factories import FactoryError
from super_gradients_tpu_torch.training.metrics import MetricCollection, get_metric, to_host
from super_gradients_tpu_torch.training.metrics import detection as det

torch.set_num_threads(2)

NMSOut = namedtuple("NMSOut", "boxes scores labels num_detections")
SEEDS = [0, 1, 2, 3]


def _boxes(rng, n, size=64.0):
    xy = rng.rand(n, 2) * size * 0.8
    wh = rng.rand(n, 2) * size * 0.4 + 2
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _near(rng, gt, n, scale):
    """Predictions around ground-truth boxes, so that IoUs spread over the thresholds."""
    idx = rng.randint(0, len(gt), n)
    return (gt[idx] + rng.randn(n, 4).astype(np.float32) * scale).astype(np.float32)


def _matching_case(seed):
    rng = np.random.RandomState(seed)
    gb = _boxes(rng, 12)
    gl = rng.randint(0, 3, 12)
    pb = np.concatenate([_near(rng, gb, 25, 2.0), _boxes(rng, 10)])
    pl = np.concatenate([gl[rng.randint(0, 12, 25)], rng.randint(0, 3, 10)])
    order = np.argsort(-rng.rand(len(pb)), kind="stable")
    cb, cl = np.array([[0, 0, 40, 40], [20, 20, 64, 64], [0, 30, 64, 64]], np.float32), np.array([0, 1, 2])
    return pb[order], pl[order], gb, gl, cb, cl


@pytest.mark.parametrize("seed", SEEDS)
def test_iou_ioa_equal(seed):
    pb, _, gb, _, cb, _ = _matching_case(seed)
    assert np.array_equal(det._np_iou(pb, gb), jax_det._np_iou(pb, gb))
    assert np.array_equal(det._np_ioa(pb, cb), jax_det._np_ioa(pb, cb))


@pytest.mark.parametrize("crowd", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_match_predictions_to_gt_equal(seed, crowd):
    pb, pl, gb, gl, cb, cl = _matching_case(seed)
    thr = np.linspace(0.5, 0.95, 10)
    args = (pb, pl, gb, gl, thr) + ((cb, cl) if crowd else ())
    tp, keep = det.match_predictions_to_gt(*args)
    rtp, rkeep = jax_det.match_predictions_to_gt(*args)
    assert np.array_equal(tp, rtp) and np.array_equal(keep, rkeep)
    assert tp.any() and not tp.all()  # the case is not vacuous
    if crowd:
        assert not keep.all()


@pytest.mark.parametrize("seed", SEEDS)
def test_match_distance_equal(seed):
    pb, pl, gb, gl, _, _ = _matching_case(seed)
    thr = np.array([2.0, 4.0, 8.0])
    tp, keep = det.match_predictions_to_gt_distance(pb, pl, gb, gl, thr)
    rtp, rkeep = jax_det.match_predictions_to_gt_distance(pb, pl, gb, gl, thr)
    assert np.array_equal(tp, rtp) and np.array_equal(keep, rkeep) and tp.any()


def _ap_inputs(seed, n=200, t=10, c=5):
    rng = np.random.RandomState(seed)
    tp = rng.rand(n, t) < np.linspace(0.7, 0.2, t)
    conf = np.round(rng.rand(n), 2).astype(np.float32)  # rounded: many ties
    cls = rng.randint(0, c, n)
    n_gt = rng.randint(0, 30, c)
    n_gt[0] = 0  # a class with predictions and no ground truth
    keep = rng.rand(n, t) > 0.1
    return tp, conf, cls, n_gt, keep


@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_compute_ap_and_best_thresholds_equal(seed, with_keep):
    tp, conf, cls, n_gt, keep = _ap_inputs(seed)
    keep = keep if with_keep else None
    for got, ref in zip(det.compute_ap(tp, conf, cls, n_gt, keep, score_threshold=0.3),
                        jax_det.compute_ap(tp, conf, cls, n_gt, keep, score_threshold=0.3)):
        assert np.array_equal(got, ref)
    assert det.best_score_thresholds(tp, conf, cls, n_gt, keep) == jax_det.best_score_thresholds(tp, conf, cls, n_gt, keep)
    assert det.best_score_threshold(tp, conf, cls, n_gt, keep) == jax_det.best_score_threshold(tp, conf, cls, n_gt, keep)


def _batches(seed, n_batches=3, b=4, max_pred=30, max_boxes=10, num_cls=4, crowd=False):
    """(NMS output, targets) pairs as the validation loop hands them to update()."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        targets = np.full((b, max_boxes, 6 if crowd else 5), -1.0, np.float32)
        boxes = np.zeros((b, max_pred, 4), np.float32)
        scores = np.zeros((b, max_pred), np.float32)
        labels = np.full((b, max_pred), -1, np.int32)
        nums = rng.randint(0, max_pred + 1, b).astype(np.int32)
        for i in range(b):
            g = rng.randint(1, max_boxes)
            gb, gl = _boxes(rng, g), rng.randint(0, num_cls, g)
            targets[i, :g, 0], targets[i, :g, 1:5] = gl, gb
            if crowd:
                targets[i, :g, 5] = rng.rand(g) < 0.2
            n = nums[i]
            boxes[i, :n] = np.concatenate([_near(rng, gb, n // 2, 1.5), _boxes(rng, n - n // 2)])
            labels[i, :n] = np.concatenate([gl[rng.randint(0, g, n // 2)], rng.randint(0, num_cls, n - n // 2)])
            scores[i, :n] = np.round(rng.rand(n), 3)
        out.append((NMSOut(boxes, scores, labels, nums), targets))
    return out


VARIANTS = {
    "DetectionMetrics": dict(num_cls=4),
    "DetectionMetrics_050": dict(num_cls=4),
    "DetectionMetrics_075": dict(num_cls=4),
    "DetectionMetrics_050_095": dict(num_cls=4, score_thres=0.3),
    "DetectionMetricsDistanceBased": dict(num_cls=4, distance_thresholds=[3.0, 6.0]),
    "classwise": dict(num_cls=4, include_classwise_ap=True, class_names=["a", "b", "c", "d"]),
    "classwise_no_names": dict(num_cls=4, include_classwise_ap=True, calc_best_score_thresholds=True),
}


@pytest.mark.parametrize("crowd", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_detection_metrics_update_compute_equal(variant, crowd):
    name = variant if not variant.startswith("classwise") else "DetectionMetrics"
    got_m, ref_m = get_metric({name: VARIANTS[variant]}), jax_get_metric({name: VARIANTS[variant]})
    assert type(got_m).__name__ == type(ref_m).__name__
    got, ref = got_m.init(), ref_m.init()
    for nms_out, targets in _batches(7, crowd=crowd):
        got = got_m.update(got, nms_out, targets)
        ref = ref_m.update(ref, nms_out, targets)
    got_r, ref_r = got_m.compute(got), ref_m.compute(ref)
    assert got_r == ref_r
    assert 0 < got_r[next(k for k in got_r if k.startswith("mAP@"))] < 1
    if variant.startswith("classwise"):
        assert any(k.startswith("AP@") for k in got_r) and any(k.startswith("Best_score_threshold_") for k in got_r)


def test_empty_state_and_no_ground_truth():
    m, r = det.DetectionMetrics(num_cls=3), jax_det.DetectionMetrics(num_cls=3)
    assert m.compute(m.init()) == r.compute(r.init())
    nms_out = NMSOut(np.zeros((1, 5, 4), np.float32), np.ones((1, 5), np.float32), np.zeros((1, 5), np.int32),
                     np.array([5], np.int32))
    targets = np.full((1, 4, 5), -1.0, np.float32)
    assert m.compute(m.update(m.init(), nms_out, targets)) == r.compute(r.update(r.init(), nms_out, targets))


@pytest.mark.parametrize("multi_label", [True, False])
def test_preprocess_device_matches_jax(multi_label):
    """Each side's NMS on the same decoded outputs ([2, 500, 6]; more anchors than
    nms_top_k=64, so the two-stage prefilter runs)."""
    Outputs = namedtuple("Outputs", "pred_bboxes pred_scores")
    rng = np.random.RandomState(3)
    xy = rng.rand(2, 500, 2).astype(np.float32) * 60
    boxes = np.concatenate([xy, xy + rng.rand(2, 500, 2).astype(np.float32) * 20 + 2], -1)
    scores = rng.rand(2, 500, 6).astype(np.float32)
    kw = dict(num_cls=6, nms_top_k=64, max_predictions=40, multi_label_per_box=multi_label, score_threshold=0.3)
    got = det.DetectionMetrics(**kw).preprocess_device(Outputs(torch.from_numpy(boxes), torch.from_numpy(scores)), None)
    ref = jax_det.DetectionMetrics(**kw).preprocess_device(Outputs(jnp.asarray(boxes), jnp.asarray(scores)), None)
    got, ref = to_host(got), [np.asarray(t) for t in ref]
    assert (got.num_detections > 0).all()
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)


def test_get_metric_and_collection():
    m = get_metric("DetectionMetrics_050")
    assert isinstance(m, det.DetectionMetrics_050) and get_metric(m) is m
    assert get_metric({"DetectionMetrics": {"num_cls": 7}}).num_cls == 7
    with pytest.raises(KeyError, match="ROADMAP"):
        get_metric("DepthMAE")
    with pytest.raises(FactoryError, match="Did you mean `DetectionMetrics`"):
        get_metric("detectionmetrics")
    coll = MetricCollection([det.DetectionMetrics(num_cls=4), det.DetectionMetrics_050(num_cls=4)])
    states = coll.init()
    nms_out, targets = _batches(2, n_batches=1)[0]
    states = coll.update_host(states, (nms_out, nms_out), targets)
    out = coll.compute(states)
    assert {"mAP@0.50:0.95", "mAP@0.50", "Recall@0.50"} <= set(out) and coll.has_host_metrics()
