"""YoloNASPoseLoss of the PyTorch port against the JAX package's, on the same inputs.

Synthetic head outputs of a 64x64 image (84 anchors over strides 8, 16, 32; one class,
17 joints, ``reg_max`` 16) and padded targets ``[B, 6, 5 + 3*17]`` (``-1`` rows pad;
visibility 0, 1 or 2) made with numpy from a seed. Each anchor's keypoints lie near one
person's, so that the OKS factor of the assigner is neither 0 nor 1. They go through the
JAX ``YoloNASPoseLoss`` (jitted, ``jax.value_and_grad``) and the port's (autograd), under
every switch: the assigner's OKS factor, the rescale by the assigned score, focal or BCE
joint visibility. Tolerances, fp32 on the CPU: loss and components ``rtol=1e-5``; the
assigner's labels and gt indices exactly equal, its boxes and scores to ``atol=1e-6``;
``batch_pose_oks`` to ``atol=1e-6``; the gradients with respect to ``cls_logits``,
``reg_distri``, ``pose_logits`` and ``pred_pose_coords`` to ``atol=1e-6, rtol=1e-4``.

A negative anchor whose ``gt_index`` points at a padding row (area 0) has ``exp(-e) = 0``:
its gradient is 0, never NaN, in fp32 and under the bf16 policy (the loss in fp32).
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.models.class_names import COCO_POSE_SIGMAS as JAX_SIGMAS
from super_gradients_tpu.training.losses import yolo_nas_pose_loss as jax_loss
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.models.class_names import COCO_POSE_SIGMAS
from super_gradients_tpu_torch.training import dataloaders
from super_gradients_tpu_torch.training.losses import get_loss, yolo_nas_pose_loss
from super_gradients_tpu_torch.training.mixed_precision import autocast, to_f32

torch.set_num_threads(2)

Outputs = namedtuple("Outputs", "cls_logits reg_distri pose_logits pred_pose_coords anchor_points stride_tensor "
                                "num_anchors_list")
J, REG_MAX, IMAGE, MAX_POSES = 17, 16, 64, 6
STRIDES = (8, 16, 32)
GRAD_NAMES = ("cls_logits", "reg_distri", "pose_logits", "pred_pose_coords")


def _anchors():
    points, strides = [], []
    for s in STRIDES:
        n = IMAGE // s
        gy, gx = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5, indexing="ij")
        points.append(np.stack([gx, gy], -1).reshape(-1, 2))
        strides.append(np.full((n * n, 1), float(s)))
    return np.concatenate(points).astype(np.float32), np.concatenate(strides).astype(np.float32), \
        tuple(len(p) for p in points)


POINTS, STRIDE_T, COUNTS = _anchors()
L = len(POINTS)


def case(seed, counts=(3, 5)):
    rng = np.random.RandomState(seed)
    b = len(counts)
    targets = np.full((b, MAX_POSES, 5 + 3 * J), -1.0, np.float32)
    pred_kpts = np.zeros((b, L, J, 2), np.float32)
    for i, n in enumerate(counts):
        xy = rng.rand(n, 2) * 36
        wh = rng.rand(n, 2) * 24 + 12
        x2y2 = np.minimum(xy + wh, IMAGE)
        kx = rng.uniform(xy[:, :1], x2y2[:, :1], (n, J))
        ky = rng.uniform(xy[:, 1:], x2y2[:, 1:], (n, J))
        vis = rng.randint(0, 3, (n, J)).astype(np.float32)
        targets[i, :n, 0] = 0.0
        targets[i, :n, 1:5] = np.concatenate([xy, x2y2], 1)
        targets[i, :n, 5:] = np.stack([kx, ky, vis], -1).reshape(n, 3 * J)
        if n:
            near = rng.randint(0, n, L)  # each anchor predicts near one person's joints
            pred_kpts[i] = np.stack([kx[near], ky[near]], -1) + rng.randn(L, J, 2) * 3
    cls_logits = (rng.randn(b, L, 1) * 2).astype(np.float32)
    reg = (rng.randn(b, L, 4 * (REG_MAX + 1)) * 2).astype(np.float32)
    pose_logits = (rng.randn(b, L, J) * 2).astype(np.float32)
    return dict(cls_logits=cls_logits, reg_distri=reg, pose_logits=pose_logits, pred_pose_coords=pred_kpts), targets


SWITCHES = {
    "default": {},
    "no_oks_in_assigner": {"assigner_multiply_by_pose_oks": False},
    "no_rescale": {"rescale_pose_loss_with_assigned_score": False},
    "bce": {"pose_classification_loss_type": "bce"},
}


# (seed, persons in each image); an image without a person has every anchor's gt_index
# on a padding row
CASES = {"a": (0, (3, 5)), "b": (1, (2, 6)), "empty_image": (4, (4, 0))}


def _jax_run(seed, switches, counts):
    arrays, targets = case(seed, counts)
    loss = jax_loss.YoloNASPoseLoss(**switches)

    def f(*xs):
        out = Outputs(*xs, jnp.asarray(POINTS), jnp.asarray(STRIDE_T), COUNTS)
        return loss(out, jnp.asarray(targets))

    (value, comps), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(arrays[k]) for k in GRAD_NAMES))
    return float(value), {k: float(v) for k, v in comps.items()}, [np.asarray(g) for g in grads]


def _port_run(seed, switches, counts):
    arrays, targets = case(seed, counts)
    xs = [torch.from_numpy(arrays[k]).requires_grad_() for k in GRAD_NAMES]
    loss = get_loss("YoloNASPoseLoss", switches)
    value, comps = loss(Outputs(*xs, torch.from_numpy(POINTS), torch.from_numpy(STRIDE_T), COUNTS),
                        torch.from_numpy(targets))
    value.backward()
    return float(value.detach()), {k: float(v.detach()) for k, v in comps.items()}, [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("switch", list(SWITCHES))
@pytest.mark.parametrize("name", list(CASES))
def test_loss_components_and_gradients_match_jax(switch, name):
    jv, jc, jg = _jax_run(*CASES[name][:1], SWITCHES[switch], CASES[name][1])
    pv, pc, pg = _port_run(*CASES[name][:1], SWITCHES[switch], CASES[name][1])
    assert set(pc) == set(jc) == {"loss_cls", "loss_iou", "loss_dfl", "loss_pose_cls", "loss_pose_reg"}
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    for k in jc:
        np.testing.assert_allclose(pc[k], jc[k], rtol=1e-5, err_msg=k)
    assert jc["loss_pose_reg"] > 0 and jc["loss_iou"] > 0
    for name, g, r in zip(GRAD_NAMES, pg, jg):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-4, err_msg=name)


def test_batch_pose_oks_matches_jax():
    arrays, targets = case(2)
    gt_kpts = targets[..., 5:].reshape(2, MAX_POSES, J, 3)
    gt_boxes = targets[..., 1:5]
    ref = jax_loss.batch_pose_oks(jnp.asarray(gt_kpts), jnp.asarray(arrays["pred_pose_coords"]), jnp.asarray(gt_boxes),
                                  jnp.asarray(JAX_SIGMAS, jnp.float32))
    got = yolo_nas_pose_loss.batch_pose_oks(torch.from_numpy(gt_kpts), torch.from_numpy(arrays["pred_pose_coords"]),
                                            torch.from_numpy(gt_boxes), torch.tensor(COCO_POSE_SIGMAS))
    assert got.shape == (2, MAX_POSES, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    assert 0.01 < float(got[0, :3].mean()) < 0.99  # neither vanishing nor saturated


@pytest.mark.parametrize("multiply", [True, False])
def test_assigner_matches_jax(multiply):
    arrays, targets = case(3)
    cls = arrays["cls_logits"]
    scores = 1 / (1 + np.exp(-cls))
    rng = np.random.RandomState(3)
    xy = POINTS * STRIDE_T
    pred_boxes = np.concatenate([xy - rng.rand(L, 2) * 20 - 4, xy + rng.rand(L, 2) * 20 + 4], -1)[None].repeat(2, 0)
    pred_boxes = pred_boxes.astype(np.float32)
    gt_kpts = targets[..., 5:].reshape(2, MAX_POSES, J, 3)
    pad = (targets[..., 0] >= 0).astype(np.float32)
    kw = dict(pred_scores=scores.astype(np.float32), pred_bboxes=pred_boxes, pred_kpts=arrays["pred_pose_coords"],
              anchor_points=xy.astype(np.float32), gt_bboxes=targets[..., 1:5], gt_kpts=gt_kpts, pad_gt_mask=pad)
    ja = jax_loss.PoseTaskAlignedAssigner(jnp.asarray(JAX_SIGMAS, jnp.float32), multiply_by_pose_oks=multiply)
    ref = ja.assign(**{k: jnp.asarray(v) for k, v in kw.items()})
    pa = yolo_nas_pose_loss.PoseTaskAlignedAssigner(COCO_POSE_SIGMAS, multiply_by_pose_oks=multiply)
    got = pa(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in kw.items()})
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.gt_index.numpy(), np.asarray(ref.gt_index))
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(ref.bboxes), atol=1e-6)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-6)
    positives = got.labels.numpy() != 1  # background is index 1 with one class
    assert 0 < positives.sum() < positives.size


def test_oks_sigmas_none_raises_as_in_jax():
    """The JAX loss fails on ``oks_sigmas=None`` (its YAML train params pass it); so does the port's."""
    with pytest.raises((TypeError, ValueError)):
        jax_loss.YoloNASPoseLoss(oks_sigmas=None)
    with pytest.raises(ValueError, match="oks_sigmas"):
        get_loss("YoloNASPoseLoss", {"oks_sigmas": None})


@pytest.mark.parametrize("bf16", [False, True])
def test_padding_rows_give_finite_zero_gradients(bf16):
    """A model's outputs on ``pose_test_dataloader`` targets (most rows padding): every
    gradient of the network is finite in fp32 and under the bf16 policy, and the pose
    regression term takes no gradient from the anchors whose gt is a padding row."""
    model = models.get("yolo_nas_pose_n", image_size=IMAGE, device="cpu")
    net = model.net.train()
    images, targets = next(iter(dataloaders.get("pose_test_dataloader", dataloader_params={"batch_size": 4})))
    targets[1] = -1.0  # an image without a person: each anchor's gt_index is a padding row
    with autocast(torch.device("cpu"), bf16):
        out = net(images)
    out = to_f32(out)
    coords = out.pred_pose_coords.detach().requires_grad_()
    loss_fn = get_loss("YoloNASPoseLoss", {})
    loss, comps = loss_fn(out._replace(pred_pose_coords=coords), targets)
    assert comps["loss_pose_reg"].dtype == torch.float32 and torch.isfinite(loss)
    loss.backward()
    assert all(p.grad is None or torch.isfinite(p.grad).all() for p in net.parameters())
    assign = loss_fn.assign(out, targets)
    padded = torch.gather(targets[..., 0], 1, assign.gt_index) < 0  # [B, A]: the anchor's gt is padding
    assert padded.any() and torch.isfinite(coords.grad).all()
    assert torch.count_nonzero(coords.grad[padded]) == 0
