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


@pytest.mark.cuda
def test_batch_size_probe_reads_peak_memory_and_leaves_the_model():
    """The pre-launch probe: a real forward and backward at each batch, a peak that grows
    with the batch, the weights and BN statistics as they were, no gradient left."""
    _needs_cuda()
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.training.losses import get_loss
    from super_gradients_tpu_torch.training.pre_launch_callbacks import estimate_train_step_memory_gb

    model = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cuda")
    loss = get_loss("PPYoloELoss", {"num_classes": 4})
    targets = torch.tensor([[0, 8.0, 8.0, 40.0, 40.0]], device="cuda")

    def loss_fn(out, t):  # detection targets for the probe's batch
        return loss(out, targets.expand(t.shape[0], 1, 5).contiguous())

    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    gbs = [estimate_train_step_memory_gb(model, b, (64, 64), loss_fn) for b in (2, 8)]
    assert 0 < gbs[0] < gbs[1]
    assert all(torch.equal(before[k], v) for k, v in model.net.state_dict().items())
    assert all(p.grad is None for p in model.net.parameters()) and not model.net.training


@pytest.mark.cuda
def test_fp32_train_step_on_the_card_stays_near_fp64():
    """``Trainer.prepare`` keeps an fp32 train copy NCHW on the card (``channels_last_training``):
    one fp32 ResNet-18-CIFAR step's gradients (TF32 off) land within 9x the CPU's distance to
    fp64 (cuDNN's fp32 convolutions alone land 2.8-8.6x the CPU's, ``tools/cudnn_conv_drift.py``;
    2.6x here on an H100), where cuDNN's channels_last train-mode BatchNorm put them ~3900x."""
    _needs_cuda()
    from super_gradients_tpu_torch import models
    from super_gradients_tpu_torch.training import Trainer

    gen = torch.Generator().manual_seed(23)
    x, y = torch.rand((8, 3, 32, 32), generator=gen), torch.randint(0, 10, (8,), generator=gen)
    weights = models.get("resnet18_cifar", num_classes=10, seed=1, device="cpu").net.state_dict()

    def grads(device, dtype):
        model = models.get("resnet18_cifar", num_classes=10, device=device)
        model.load_state_dict(weights)
        model.net.to(dtype)
        step = Trainer("fp32_step").prepare(model, dict(loss="CrossEntropyLoss", max_epochs=1), steps_per_epoch=1)
        loss, _ = step.loss(step.forward(x.to(device, dtype)), y.to(device))
        step.backward(loss)
        return {k: p.grad.double().cpu() for k, p in step.state.net.named_parameters()}

    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = grads("cuda", torch.float32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    cpu, ref = grads("cpu", torch.float32), grads("cpu", torch.float64)

    def dist(g):
        return float(sum(((g[k] - ref[k]) ** 2).sum() for k in ref) ** 0.5)

    assert dist(card) <= 9 * dist(cpu), (dist(card), dist(cpu))
