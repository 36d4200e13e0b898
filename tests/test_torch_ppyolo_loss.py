"""PPYoloELoss of the PyTorch port against the JAX package's, on the same inputs.

Synthetic head outputs of a 64x64 image (84 anchors over strides 8, 16, 32; C=4,
``reg_max`` 16) and padded targets (``-1`` rows, an optional ``is_crowd`` column)
made with numpy from a seed go through the JAX ``PPYoloELoss`` (jitted, with
``jax.value_and_grad``) and the port's (autograd). Tolerances, fp32 on the CPU:
loss and components ``rtol=1e-5``; the assigners' labels exactly equal, their
boxes and scores to ``atol=1e-6``; the gradients with respect to ``cls_logits``
and ``reg_distri`` to ``atol=1e-6, rtol=1e-4`` (the two libraries sum the DFL
projection and the losses in other orders).

The tie fixtures pin the JAX tie order, the lowest index first: 16 anchors of one
gt with bit-equal alignment metrics (TAL keeps 13 of them), duplicate gts with
different classes (the max-IoU and the assignment argmax take the first), and a
gt centred on a grid corner, where 8 anchors are equidistant at the edge of
ATSS's nearest 9. The subnormal fixture gives 13 anchors of a gt alignment metrics
near 1e-42, which XLA flushes to 0: the TAL labels match JAX's only with the port's
flush.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.training.losses import ppyolo_loss as jax_loss
from super_gradients_tpu_torch.training.losses import get_loss
from super_gradients_tpu_torch.training.losses import ppyolo_loss

torch.set_num_threads(2)

Outputs = namedtuple("Outputs", "cls_logits reg_distri anchor_points stride_tensor num_anchors_list")
C, REG_MAX, IMAGE = 4, 16, 64
STRIDES = (8, 16, 32)


def _anchors():
    points, strides = [], []
    for s in STRIDES:
        n = IMAGE // s
        gy, gx = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5, indexing="ij")
        points.append(np.stack([gx, gy], -1).reshape(-1, 2))
        strides.append(np.full((n * n, 1), float(s)))
    counts = tuple(len(p) for p in points)
    return np.concatenate(points).astype(np.float32), np.concatenate(strides).astype(np.float32), counts


POINTS, STRIDE_T, COUNTS = _anchors()
L = len(POINTS)


def _random_case(seed, crowd=False, n=8):
    rng = np.random.RandomState(seed)
    cls_logits = (rng.randn(2, L, C) * 2).astype(np.float32)
    reg = (rng.randn(2, L, 4 * (REG_MAX + 1)) * 2).astype(np.float32)
    targets = np.full((2, n, 6 if crowd else 5), -1.0, np.float32)
    for b, count in enumerate((3, 5)):
        xy = rng.rand(count, 2) * 40
        wh = rng.rand(count, 2) * 30 + 8
        targets[b, :count, 0] = rng.randint(0, C, count)
        targets[b, :count, 1:5] = np.concatenate([xy, np.minimum(xy + wh, IMAGE)], 1)
        if crowd:
            targets[b, :count, 5] = 0.0
    if crowd:
        targets[1, 1, 5] = 1.0  # one crowd region: excluded from assignment and loss
    return cls_logits, reg, targets


def _two_hot_logits(d):
    """DFL logits whose softmax expectation is exactly d (a multiple of 0.5 in [0, 15])."""
    logits = np.full(REG_MAX + 1, -1e4, np.float32)
    lo = int(np.floor(d))
    logits[lo] = 0.0
    if d != lo:
        logits[lo + 1] = 0.0
    return logits


def _tie_case():
    """Bit-equal TAL metrics for 16 anchors of one gt, and duplicate gts."""
    cls_logits, reg, targets = _random_case(7)
    box = np.array([8.0, 8.0, 40.0, 40.0], np.float32)
    targets[0, :3] = -1.0
    targets[0, 0] = [2, *box]
    targets[0, 1] = [1, *box]  # same box, other class: the first row must win
    targets[0, 2] = [3, 44.0, 2.0, 62.0, 30.0]
    for a in range(COUNTS[0]):  # stride-8 anchors strictly inside the box predict the box itself
        x, y = POINTS[a] * 8
        if 8 < x < 40 and 8 < y < 40:
            ltrb = ((x - 8) / 8, (y - 8) / 8, (40 - x) / 8, (40 - y) / 8)
            reg[0, a] = np.concatenate([_two_hot_logits(d) for d in ltrb])
            cls_logits[0, a, :] = 1.0
    return cls_logits, reg, targets


def _equidistant_case():
    """A gt centred on the stride-8 grid corner (16, 16): 4 anchors at distance
    sqrt(32), then 8 at sqrt(160), of which ATSS's nearest 9 keep 5."""
    cls_logits, reg, targets = _random_case(8)
    targets[0, 0] = [1, 4.0, 4.0, 28.0, 28.0]
    targets[1, 0] = [0, 0.0, 0.0, 32.0, 32.0]
    return cls_logits, reg, targets


def _subnormal_case():
    """A 32x32 gt over 16 stride-8 anchors: 3 of them predict it exactly, the other 13
    predict boxes of ~0.02 px a side around their own centre. Those 13 have IoUs near
    1e-7 and alignment metrics ``score * IoU^6`` near 1e-42, below fp32's smallest
    normal: XLA flushes them to 0, so JAX's top-13 fills up with zero metrics in index
    order (anchors outside the gt), and only the 3 good anchors are positive."""
    cls_logits, reg, targets = _random_case(9)
    targets[0, :3] = -1.0
    targets[0, 0] = [1, 16.0, 16.0, 48.0, 48.0]
    tiny = np.full(REG_MAX + 1, -1e4, np.float32)
    tiny[:2] = [0.0, -7.4]  # expectation ~6e-4 of a stride: 0.005 px at stride 8
    inside = [a for a in range(COUNTS[0]) if 16 < POINTS[a, 0] * 8 < 48 and 16 < POINTS[a, 1] * 8 < 48]
    for j, a in enumerate(inside):
        x, y = POINTS[a] * 8
        if j in (5, 6, 9):
            ltrb = ((x - 16) / 8, (y - 16) / 8, (48 - x) / 8, (48 - y) / 8)
            reg[0, a] = np.concatenate([_two_hot_logits(d) for d in ltrb])
        else:
            reg[0, a] = np.tile(tiny, 4)
        cls_logits[0, a, :] = 1.0
    return cls_logits, reg, targets


CASES = {"random": lambda: _random_case(0), "crowd": lambda: _random_case(1, crowd=True),
         "ties": _tie_case, "equidistant": _equidistant_case, "subnormal": _subnormal_case}


def _jax_outputs(cls_logits, reg):
    return Outputs(cls_logits, reg, jnp.asarray(POINTS), jnp.asarray(STRIDE_T), COUNTS)


def _port_outputs(cls_logits, reg):
    return Outputs(cls_logits, reg, torch.from_numpy(POINTS), torch.from_numpy(STRIDE_T), COUNTS)


def _jax_run(case, static, varifocal):
    cls_logits, reg, targets = CASES[case]()
    loss = jax_loss.PPYoloELoss(num_classes=C, use_static_assigner=static, use_varifocal_loss=varifocal)

    def f(c, r):
        return loss(_jax_outputs(c, r), jnp.asarray(targets))

    (value, comps), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(cls_logits), jnp.asarray(reg))
    return float(value), {k: float(v) for k, v in comps.items()}, [np.asarray(g) for g in grads]


def _port_run(case, static, varifocal):
    cls_logits, reg, targets = CASES[case]()
    c = torch.from_numpy(cls_logits).requires_grad_()
    r = torch.from_numpy(reg).requires_grad_()
    loss = get_loss("PPYoloELoss", {"num_classes": C, "use_static_assigner": static, "use_varifocal_loss": varifocal})
    value, comps = loss(_port_outputs(c, r), torch.from_numpy(targets))
    value.backward()
    return float(value.detach()), {k: float(v.detach()) for k, v in comps.items()}, [c.grad.numpy(), r.grad.numpy()]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("static,varifocal", [(False, True), (True, True), (False, False), (True, False)],
                         ids=["tal-varifocal", "atss-varifocal", "tal-focal", "atss-focal"])
def test_loss_components_and_grads_match_jax(case, static, varifocal):
    ref_value, ref_comps, ref_grads = _jax_run(case, static, varifocal)
    value, comps, grads = _port_run(case, static, varifocal)
    assert np.isfinite(value) and ref_comps["loss_iou"] > 0
    np.testing.assert_allclose(value, ref_value, rtol=1e-5)
    for k in ("loss_cls", "loss_iou", "loss_dfl"):
        np.testing.assert_allclose(comps[k], ref_comps[k], rtol=1e-5, err_msg=k)
    for name, g, r in zip(("cls_logits", "reg_distri"), grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-4, err_msg=f"d loss / d {name}")


def _jax_assign(case, static):
    cls_logits, reg, targets = CASES[case]()
    t = jnp.asarray(targets)
    gt_labels, gt_bboxes = jnp.maximum(t[..., 0], 0).astype(jnp.int32), t[..., 1:5]
    pad = (t[..., 0] >= 0).astype(jnp.float32)
    if targets.shape[-1] >= 6:
        pad = pad * (t[..., 5] <= 0)
    d = jnp.asarray(reg).reshape(2, L, 4, REG_MAX + 1)
    dist = jnp.einsum("blnk,k->bln", jax.nn.softmax(d, -1), jnp.arange(REG_MAX + 1, dtype=jnp.float32))
    pts, st = jnp.asarray(POINTS), jnp.asarray(STRIDE_T)
    pred_px = jnp.concatenate([pts - dist[..., :2], pts + dist[..., 2:]], -1) * st[None]
    if static:
        half = 5.0 * st[:, 0] * 0.5
        anchors = jnp.concatenate([pts * st - jnp.stack([half, half], -1), pts * st + jnp.stack([half, half], -1)], -1)
        out = jax_loss.ATSSAssigner(topk=9)(anchors, COUNTS, gt_labels, gt_bboxes, pad, C, pred_bboxes=pred_px)
    else:
        out = jax_loss.TaskAlignedAssigner()(jax.nn.sigmoid(jnp.asarray(cls_logits)), pred_px, pts * st, gt_labels,
                                              gt_bboxes, pad, C)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("static", [False, True], ids=["tal", "atss"])
def test_assigner_matches_jax(case, static):
    cls_logits, reg, targets = CASES[case]()
    loss = ppyolo_loss.PPYoloELoss(num_classes=C, use_static_assigner=static)
    got = loss.assign(_port_outputs(torch.from_numpy(cls_logits), torch.from_numpy(reg)), torch.from_numpy(targets))
    labels, bboxes, scores, gt_index = _jax_assign(case, static)
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    fg = labels != C
    assert fg.sum() > 0
    np.testing.assert_array_equal(got.gt_index.numpy()[fg], gt_index[fg])
    np.testing.assert_allclose(got.bboxes.numpy(), bboxes, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), scores, atol=1e-6, rtol=0)


def test_tal_tie_picks_lowest_anchors_and_first_gt():
    """16 anchors of gt 0 (and of its duplicate, gt 1) tie bit for bit; TAL keeps
    the 13 lowest-indexed, and every one goes to gt 0, the first of the two."""
    cls_logits, reg, targets = _tie_case()
    loss = ppyolo_loss.PPYoloELoss(num_classes=C)
    got = loss.assign(_port_outputs(torch.from_numpy(cls_logits), torch.from_numpy(reg)), torch.from_numpy(targets))
    inside = [a for a in range(COUNTS[0]) if 8 < POINTS[a, 0] * 8 < 40 and 8 < POINTS[a, 1] * 8 < 40]
    assert len(inside) == 16
    labels = got.labels[0].numpy()
    assert [a for a in inside if labels[a] == 2] == inside[:13]
    assert all(labels[a] == C for a in inside[13:])
    assert (got.gt_index[0].numpy()[inside[:13]] == 0).all()


def test_subnormal_case_reaches_subnormal_metrics():
    """The fixture is not vacuous: before the flush, 13 stride-8 anchors of the gt have
    subnormal alignment metrics, and after it only the 3 good ones of that level are
    positive, as in JAX (``test_assigner_matches_jax[tal-subnormal]`` holds every label)."""
    cls_logits, reg, targets = _subnormal_case()
    loss = ppyolo_loss.PPYoloELoss(num_classes=C)
    captured = []
    original = ppyolo_loss.flush_subnormals

    def spy(t):
        captured.append(t.clone())
        return original(t)

    ppyolo_loss.flush_subnormals = spy
    try:
        got = loss.assign(_port_outputs(torch.from_numpy(cls_logits), torch.from_numpy(reg)), torch.from_numpy(targets))
    finally:
        ppyolo_loss.flush_subnormals = original
    (metrics,) = captured
    inside = [a for a in range(COUNTS[0]) if 16 < POINTS[a, 0] * 8 < 48 and 16 < POINTS[a, 1] * 8 < 48]
    row = metrics[0, 0, inside]
    tiny = torch.finfo(torch.float32).tiny
    assert int(((row > 0) & (row < tiny)).sum()) == 13 and int((row >= tiny).sum()) == 3
    positive = ((got.labels[0] != C) & (got.gt_index[0] == 0))[: COUNTS[0]]  # the stride-8 level
    assert positive.nonzero()[:, 0].tolist() == [inside[j] for j in (5, 6, 9)]


def test_atss_equidistant_tie_keeps_lowest_indices():
    cls_logits, reg, targets = _equidistant_case()
    d = np.hypot(*(POINTS[: COUNTS[0]] * 8 - 16.0).T)
    order = np.argsort(d, kind="stable")[:9]
    assert np.isclose(d[order[-1]], np.sqrt(160)) and (np.isclose(d, np.sqrt(160))).sum() == 8
    idx = ppyolo_loss._sorted_indices(torch.from_numpy(d.astype(np.float32)), descending=False)[:9]
    assert idx.tolist() == order.tolist()


def test_gather_topk_anchors_matches_iterative_argmax_on_ties():
    metrics = np.random.RandomState(3).randint(0, 3, size=(2, 5, 40)).astype(np.float32)
    mask = (np.arange(5) < 4).astype(np.float32)[None, :, None].repeat(2, 0)
    ref = np.asarray(jax_loss.gather_topk_anchors(jnp.asarray(metrics), 13, topk_mask=jnp.asarray(mask)))
    got = ppyolo_loss.gather_topk_anchors(torch.from_numpy(metrics), 13, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("fn", ["giou_loss", "df_loss", "varifocal_loss", "focal_loss"])
def test_elementwise_losses_match_jax(fn):
    rng = np.random.RandomState(4)
    xy = rng.rand(3, 7, 2) * 20
    pred = np.concatenate([xy, xy + rng.rand(3, 7, 2) * 10], -1).astype(np.float32)
    xy = rng.rand(3, 7, 2) * 20
    target = np.concatenate([xy, xy + rng.rand(3, 7, 2) * 10], -1).astype(np.float32)
    logits = (rng.randn(3, 7, C) * 3).astype(np.float32)
    label = (rng.rand(3, 7, C) > 0.7).astype(np.float32)
    score = (rng.rand(3, 7, C) * label).astype(np.float32)
    dist = rng.randn(3, 7, 4, REG_MAX + 1).astype(np.float32)
    ltrb = (rng.rand(3, 7, 4) * (REG_MAX - 0.01)).astype(np.float32)
    args = {"giou_loss": (pred, target), "df_loss": (dist, ltrb), "varifocal_loss": (logits, score, label),
            "focal_loss": (logits, label)}[fn]
    ref = np.asarray(getattr(jax_loss, fn)(*map(jnp.asarray, args)))
    got = getattr(ppyolo_loss, fn)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_get_loss_unknown_name():
    with pytest.raises(KeyError, match="PPYoloELoss"):
        get_loss("PPYoloLoss")
