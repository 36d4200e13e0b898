"""The pose path on a GPU (``cuda`` marker; each test skips without one). No JAX here: the
CPU tests hold the port's pose modules to JAX, and these hold the card to the CPU. Run on
the GPU machine with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_pose_cuda.py``.
"""

import numpy as np
import pytest
import torch

from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.ops import nms
from super_gradients_tpu_torch.ops.kernels import nms_exact
from super_gradients_tpu_torch.training import dataloaders
from super_gradients_tpu_torch.training.losses import get_loss
from super_gradients_tpu_torch.training.metrics import pose_estimation, to_host


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _model(device):
    model = models.get("yolo_nas_pose_n", image_size=128, device=device, seed=0)
    for name, module in model.net.named_modules():
        if name.endswith("cls_pred"):
            module.bias.data.zero_()
    return model


def _batch(b=4):
    return next(iter(dataloaders.get("pose_test_dataloader", dataloader_params={
        "batch_size": b, "dataset_size": b, "image_size": (128, 128)})))


@pytest.mark.cuda
def test_pose_metric_state_on_the_card_equals_the_cpu():
    """The same outputs on the card and moved to the CPU: bit-equal pose NMS (K1 on the
    card, once, and its plain version on the CPU) and an equal metric state."""
    _needs_cuda()
    model = _model("cuda")
    images, targets = _batch()
    with torch.inference_mode():
        out = model.net(images.cuda())
    outputs = {"cuda": out, "cpu": type(out)(*(t.cpu() if torch.is_tensor(t) else t for t in out))}
    metric = pose_estimation.PoseEstimationMetrics(post_prediction_conf=0.01)
    states, nms = {}, {}
    for device, o in outputs.items():
        before = nms_exact.exact_nms_keep.launches
        nms[device] = to_host(metric.preprocess_device(o, None))
        assert nms_exact.exact_nms_keep.launches - before == (device == "cuda")
        states[device] = metric.update(metric.init(), nms[device], targets.numpy())
    for g, r in zip(nms["cuda"], nms["cpu"]):
        assert np.array_equal(g, r)
    assert metric.compute(states["cuda"]) == metric.compute(states["cpu"])


@pytest.mark.cuda
def test_pose_predict_on_the_card_launches_k1():
    _needs_cuda()
    model = _model("cuda")
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((100, 140), (128, 128), (90, 50))]
    before = nms_exact.exact_nms_keep.launches
    preds = model.predict(images, conf=0.05)
    assert nms_exact.exact_nms_keep.launches == before + 1
    assert all(len(p) > 0 and np.isfinite(p.poses).all() for p in preds)


@pytest.mark.cuda
def test_pose_loss_on_the_card_equals_the_cpu():
    """fp32, TF32 off: the loss of the same outputs and targets on the card and the CPU."""
    _needs_cuda()
    model = _model("cpu")
    images, targets = _batch()
    with torch.no_grad():
        out = model.net.train()(images)
    loss = get_loss("YoloNASPoseLoss", {})
    cpu_value, cpu_comps = loss(out, targets)
    gpu_out = type(out)(*(t.cuda() if torch.is_tensor(t) else t for t in out))
    gpu_value, gpu_comps = loss(gpu_out, targets.cuda())
    for k, v in cpu_comps.items():
        np.testing.assert_allclose(float(gpu_comps[k]), float(v), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(gpu_value), float(cpu_value), rtol=1e-4)


@pytest.mark.cuda
def test_batched_pose_nms_launches_k1_on_the_card_and_equals_the_cpu():
    """Exact pose NMS at the predict path's size (8400 anchors, 1024 candidates): one K1
    launch on the card, outputs bit-equal to the CPU's plain version."""
    _needs_cuda()
    g = torch.Generator().manual_seed(1)
    b, a, j = 8, 8400, 17
    xy = torch.rand((b, a, 2), generator=g) * 600
    boxes = torch.cat([xy, xy + torch.rand((b, a, 2), generator=g) * 80 + 4], -1)
    scores = (torch.randint(0, 50, (b, a, 1), generator=g) / 50).float()
    coords, joint_scores = torch.rand((b, a, j, 2), generator=g) * 640, torch.rand((b, a, j), generator=g)
    arrays = (boxes, scores, coords, joint_scores)
    before = nms_exact.exact_nms_keep.launches
    gpu = nms.batched_pose_nms(*(x.cuda() for x in arrays), score_threshold=0.01, mode="exact")
    assert nms_exact.exact_nms_keep.launches == before + 1
    cpu = nms.batched_pose_nms(*arrays, score_threshold=0.01, mode="exact")
    for x, y in zip(gpu, cpu):
        assert torch.equal(x.cpu(), y)
