"""Tie orders of the training slice on a GPU (``cuda`` marker; each test skips
without one). No JAX here: the CPU tests hold the port's CPU results to JAX, and
these hold the card to the CPU. Run on the GPU machine with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_train_cuda.py``.
"""

import numpy as np
import pytest
import torch

from super_gradients_tpu_torch.ops.pooling import chained_max_pools
from super_gradients_tpu_torch.training.losses import ppyolo_loss


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [False, True])
def test_max_pool_backward_routes_ties_like_the_cpu(channels_last):
    _needs_cuda()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(-2, 3, size=(4, 48, 20, 20)).astype(np.float32))
    cot = [torch.from_numpy(rng.randint(-3, 4, size=x.shape).astype(np.float32)) for _ in range(3)]
    grads = []
    for device in ("cpu", "cuda"):
        xd = x.to(device, copy=True)  # a new leaf on each device
        if channels_last:
            xd = xd.contiguous(memory_format=torch.channels_last)
        xd.requires_grad_()
        outs = chained_max_pools(xd, (5, 9, 13))
        sum((o * c.to(device)).sum() for o, c in zip(outs, cot)).backward()
        grads.append(xd.grad.cpu())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_stable_sort_keeps_index_order_on_ties_at_tal_shape():
    """[B, max_boxes, 8400] with values from {0, 1, 2}: the stable sort the TAL and
    ATSS top-k use gives numpy's stable order on the card."""
    _needs_cuda()
    vals = np.random.RandomState(1).randint(0, 3, size=(2, 120, 8400)).astype(np.float32)
    for descending in (True, False):
        got = ppyolo_loss._sorted_indices(torch.from_numpy(vals).cuda(), descending=descending)[..., :13].cpu().numpy()
        ref = np.argsort(-vals if descending else vals, axis=-1, kind="stable")[..., :13]
        np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True], ids=["tal", "atss"])
def test_assigner_on_the_card_matches_the_cpu_on_ties(static):
    """A 640x640 anchor grid, duplicate gts and 16 anchors predicting exactly one gt's
    box (bit-equal TAL metrics): the same labels and gts on the card as on the CPU."""
    _needs_cuda()
    from collections import namedtuple

    Outputs = namedtuple("Outputs", "cls_logits reg_distri anchor_points stride_tensor num_anchors_list")
    points, strides = [], []
    for s in (8, 16, 32):
        n = 640 // s
        gy, gx = torch.meshgrid(torch.arange(n) + 0.5, torch.arange(n) + 0.5, indexing="ij")
        points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        strides.append(torch.full((n * n, 1), float(s)))
    pts, st = torch.cat(points), torch.cat(strides)
    counts = tuple(len(p) for p in points)
    rng = np.random.RandomState(2)
    cls_logits = torch.from_numpy((rng.randn(2, len(pts), 80) * 2).astype(np.float32))
    reg = torch.from_numpy((rng.randn(2, len(pts), 68) * 2).astype(np.float32))
    targets = torch.full((2, 120, 5), -1.0)
    box = torch.tensor([8.0, 8.0, 40.0, 40.0])
    targets[0, 0] = torch.cat([torch.tensor([2.0]), box])
    targets[0, 1] = torch.cat([torch.tensor([1.0]), box])  # duplicate: the first gt must win
    xy = torch.from_numpy(rng.rand(60, 2).astype(np.float32) * 500)
    targets[1, :60] = torch.cat([torch.from_numpy(rng.randint(0, 80, (60, 1)).astype(np.float32)), xy,
                                 xy + 20 + torch.from_numpy(rng.rand(60, 2).astype(np.float32) * 100)], 1)
    inside = [a for a in range(counts[0]) if 8 < pts[a, 0] * 8 < 40 and 8 < pts[a, 1] * 8 < 40]
    two_hot = lambda d: torch.tensor([0.0 if i in (int(d), int(d) + (d != int(d))) else -1e4 for i in range(17)])  # noqa: E731
    for a in inside:
        x, y = (pts[a] * 8).tolist()
        reg[0, a] = torch.cat([two_hot(d) for d in ((x - 8) / 8, (y - 8) / 8, (40 - x) / 8, (40 - y) / 8)])
        cls_logits[0, a] = 1.0
    loss = ppyolo_loss.PPYoloELoss(num_classes=80, use_static_assigner=static)
    results = []
    for device in ("cpu", "cuda"):
        out = Outputs(cls_logits.to(device), reg.to(device), pts.to(device), st.to(device), counts)
        results.append(loss.assign(out, targets.to(device)))
    cpu, gpu = results
    assert torch.equal(cpu.labels, gpu.labels.cpu())
    fg = cpu.labels != 80
    assert fg.sum() > 0 and torch.equal(cpu.gt_index[fg], gpu.gt_index.cpu()[fg])
    if not static:
        assert [a for a in inside if cpu.labels[0, a] == 2] == inside[:13]
