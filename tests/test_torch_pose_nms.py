"""``batched_pose_nms`` of the port against the JAX package's, on the CPU.

The same seeded candidates go through both: exact mode (the port's plain version of
kernel K1, the JAX XLA loop) and fast mode must give bit-equal poses, boxes, scores and
counts, with tied scores, padding past the kept count (``max_predictions`` beyond
``nms_top_k``) and scores under the threshold. Every mode other than ``"exact"``,
``"pallas"`` included, is fast NMS in both packages (the card's K1 launch is held to the CPU in
``tests/test_torch_pose_cuda.py``). The compaction keeps the kept
candidates in score order with ties in index order, as JAX's second ``top_k`` does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.ops import nms as jax_nms
from super_gradients_tpu_torch.ops import nms
from super_gradients_tpu_torch.ops.kernels import nms_exact

J = 17


def candidates(seed, b=3, a=240, levels=7):
    """Boxes in clusters (so that NMS suppresses), scores on a few levels (so that many
    tie), keypoints and joint scores per anchor."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(b, 6, 2) * 200 + 20
    pick = rng.randint(0, 6, (b, a))
    c = np.take_along_axis(centers, pick[..., None], axis=1) + rng.randn(b, a, 2) * 6
    wh = rng.rand(b, a, 2) * 30 + 20
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = (rng.randint(0, levels, (b, a, 1)) / levels + 0.05).astype(np.float32)
    coords = (c[:, :, None, :] + rng.randn(b, a, J, 2) * 10).astype(np.float32)
    joint_scores = rng.rand(b, a, J).astype(np.float32)
    return boxes, scores, coords, joint_scores


def _both(arrays, **kw):
    j = jax_nms.batched_pose_nms(*(jnp.asarray(x) for x in arrays), **kw)
    p = nms.batched_pose_nms(*(torch.from_numpy(x) for x in arrays), **kw)
    return j, p


def _assert_equal(j, p):
    for name in ("poses", "boxes", "scores", "num_detections"):
        np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    assert p.num_detections.dtype == torch.int32


@pytest.mark.parametrize("mode", ["exact", "fast", "pallas", "matrix"])
@pytest.mark.parametrize("top_k,max_pred,thr", [(1024, 30, 0.1), (64, 30, 0.3), (16, 30, 0.01), (240, 300, 0.5)])
def test_pose_nms_bit_equal_to_jax(mode, top_k, max_pred, thr):
    arrays = candidates(top_k + max_pred)
    j, p = _both(arrays, score_threshold=thr, iou_threshold=0.5, nms_top_k=top_k, max_predictions=max_pred,
                 mode=mode)
    _assert_equal(j, p)
    assert p.poses.shape == (3, max_pred, J, 3)
    assert int(p.num_detections.min()) > 0


def test_every_mode_but_exact_is_fast():
    """``pallas`` (which K1 serves in detection ``batched_nms``) and any other name run
    fast NMS here, as in the JAX function; a chain A > B > C where A suppresses B and B
    would suppress C tells exact (keeps C) from fast (drops C)."""
    boxes = np.array([[[0, 0, 10, 10], [4, 0, 14, 10], [8, 0, 18, 10], [50, 50, 60, 60]]], np.float32)
    scores = np.array([[0.9, 0.8, 0.7, 0.6]], np.float32)
    coords = np.zeros((1, 4, J, 2), np.float32)
    joint_scores = np.ones((1, 4, J), np.float32)
    arrays = (boxes, scores, coords, joint_scores)
    counts = {}
    for mode in ("exact", "fast", "pallas", "matrix"):
        j, p = _both(arrays, score_threshold=0.1, iou_threshold=0.3, mode=mode)
        _assert_equal(j, p)
        counts[mode] = int(p.num_detections[0])
    assert counts == {"exact": 3, "fast": 2, "pallas": 2, "matrix": 2}


def test_compaction_keeps_score_order_with_ties_in_index_order():
    """All scores tied: the kept candidates come out in anchor order (JAX's ``top_k`` tie
    order), and so they do under a non-trivial score order."""
    b, a = 2, 50
    rng = np.random.RandomState(5)
    x = rng.rand(b, a) * 500
    boxes = np.stack([x, x, x + 10, x + 10], -1).astype(np.float32)  # overlapping where close
    coords = np.broadcast_to(np.arange(a, dtype=np.float32)[None, :, None, None], (b, a, J, 2)).copy()
    joint_scores = np.ones((b, a, J), np.float32)
    for scores in (np.full((b, a), 0.5, np.float32), (rng.randint(0, 3, (b, a)) / 4 + 0.2).astype(np.float32)):
        arrays = (boxes, scores, coords, joint_scores)
        j, p = _both(arrays, score_threshold=0.1, iou_threshold=0.2, nms_top_k=a, max_predictions=a)
        _assert_equal(j, p)
        for i in range(b):
            n = int(p.num_detections[i])
            anchors = p.poses[i, :n, 0, 0].numpy().astype(int)
            order = np.lexsort((np.arange(a), -scores[i]))  # score descending, index ascending
            assert list(anchors) == [k for k in order if k in set(anchors)]


def test_exact_mode_runs_the_plain_version_on_the_cpu():
    before = nms_exact.exact_nms_keep.launches
    nms.batched_pose_nms(*(torch.from_numpy(x) for x in candidates(0)), mode="exact")
    assert nms_exact.exact_nms_keep.launches == before  # launches count the CUDA kernel only
