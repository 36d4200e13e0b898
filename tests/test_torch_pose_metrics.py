"""``PoseEstimationMetrics`` and ``oks_matrix`` of the port against the JAX package's.

Synthetic decoded outputs (``pred_bboxes``, ``pred_scores``, ``pred_pose_coords``,
``pred_pose_scores``) of 2 batches of 3 images with 84 anchors each, made with numpy
from a seed: some anchors predict a person's joints with noise of a few pixels (so that
they match at some OKS thresholds and not at others), the rest are false positives;
tied scores and an image without a person included. Both metrics run their own pose NMS
(``preprocess_device``: the port's plain version of K1 here) and host matching; the NMS
outputs are bit-equal and AP / AR equal to 1e-12.
"""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.models.class_names import COCO_POSE_SIGMAS as JAX_SIGMAS
from super_gradients_tpu.training.metrics import pose_estimation as jax_pose_metrics
from super_gradients_tpu_torch.models.class_names import COCO_POSE_SIGMAS
from super_gradients_tpu_torch.training.metrics import get_metric, to_host
from super_gradients_tpu_torch.training.metrics import pose_estimation

Outputs = namedtuple("Outputs", "pred_bboxes pred_scores pred_pose_coords pred_pose_scores")
J, A, MAX_POSES = 17, 84, 5


def batch(seed, b=3):
    rng = np.random.RandomState(seed)
    targets = np.full((b, MAX_POSES, 5 + 3 * J), -1.0, np.float32)
    boxes = np.zeros((b, A, 4), np.float32)
    coords = np.zeros((b, A, J, 2), np.float32)
    for i, n in enumerate((3, 0, 4)[:b]):
        xy = rng.rand(n, 2) * 300
        wh = rng.rand(n, 2) * 120 + 40
        kx = rng.uniform(xy[:, :1], xy[:, :1] + wh[:, :1], (n, J))
        ky = rng.uniform(xy[:, 1:], xy[:, 1:] + wh[:, 1:], (n, J))
        vis = rng.randint(0, 3, (n, J)).astype(np.float32)
        if n:
            vis[0, :] = 0  # a person without a labelled joint: OKS 0 with every prediction
            targets[i, :n, 0] = 0
            targets[i, :n, 1:5] = np.concatenate([xy, xy + wh], 1)
            targets[i, :n, 5:] = np.stack([kx, ky, vis], -1).reshape(n, 3 * J)
        for a in range(A):
            if n and a % 3 == 0:  # a noisy copy of a person
                g = rng.randint(n)
                noise = rng.rand() * 12
                coords[i, a] = np.stack([kx[g], ky[g]], -1) + rng.randn(J, 2) * noise
                boxes[i, a] = np.concatenate([xy[g], xy[g] + wh[g]]) + rng.randn(4) * noise
            else:
                c = rng.rand(2) * 400
                coords[i, a] = c + rng.randn(J, 2) * 30
                boxes[i, a] = np.concatenate([c - 30, c + 30])
    scores = (rng.randint(1, 12, (b, A, 1)) / 12).astype(np.float32)  # ties
    joint_scores = rng.rand(b, A, J).astype(np.float32)
    return Outputs(boxes, scores, coords, joint_scores), targets


def test_oks_matrix_matches_jax():
    outputs, targets = batch(0)
    gt = targets[0, :3, 5:].reshape(3, J, 3)
    box = targets[0, :3, 1:5]
    areas = (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])
    preds = np.concatenate([outputs.pred_pose_coords[0], outputs.pred_pose_scores[0][..., None]], -1)
    ref = jax_pose_metrics.oks_matrix(preds, gt, areas, np.asarray(JAX_SIGMAS))
    got = pose_estimation.oks_matrix(preds, gt, areas, np.asarray(COCO_POSE_SIGMAS))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (A, 3) and (got[:, 0] == 0).all() and 0 < got.max() < 1
    assert pose_estimation.oks_matrix(preds[:0], gt, areas, np.asarray(COCO_POSE_SIGMAS)).shape == (0, 3)


@pytest.mark.parametrize("params", [{}, {"post_prediction_conf": 0.3, "max_predictions": 10, "nms_iou": 0.5},
                                    {"iou_thresholds": [0.5, 0.75], "nms_mode": "fast"}])
def test_pose_metrics_match_jax(params):
    jm = jax_pose_metrics.PoseEstimationMetrics(num_joints=J, **params)
    pm = get_metric({"PoseEstimationMetrics": dict(num_joints=J, **params)})
    assert isinstance(pm, pose_estimation.PoseEstimationMetrics)
    js, ps = jm.init(), pm.init()
    for seed in (1, 2):
        outputs, targets = batch(seed)
        jn = jm.preprocess_device(Outputs(*(jnp.asarray(x) for x in outputs)), jnp.asarray(targets))
        pn = to_host(pm.preprocess_device(Outputs(*(torch.from_numpy(x) for x in outputs)), torch.from_numpy(targets)))
        for name in ("poses", "boxes", "scores", "num_detections"):
            np.testing.assert_array_equal(getattr(pn, name), np.asarray(getattr(jn, name)), err_msg=name)
        js = jm.update(js, jn, targets)
        ps = pm.update(ps, pn, targets)
    assert ps["n_gt"] == js["n_gt"] == 14
    for a, b in zip(ps["tp"], js["tp"]):
        np.testing.assert_array_equal(a, b)
    ref, got = jm.compute(js), pm.compute(ps)
    assert set(got) == {"AP", "AR"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-12, (k, got[k], ref[k])
    assert 0 < got["AP"] < 1 and 0 < got["AR"] < 1


def test_pose_metrics_without_predictions_or_targets():
    pm = pose_estimation.PoseEstimationMetrics()
    assert pm.compute(pm.init()) == {"AP": 0.0, "AR": 0.0}
