"""Validation on a GPU (``cuda`` marker; each test skips without one). No JAX here:
the CPU tests hold the port's CPU metrics to JAX, and these hold the card to the
CPU. Run on the GPU machine with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_validation_cuda.py``.
"""

import numpy as np
import pytest
import torch

from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.ops.kernels import nms_exact
from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer
from super_gradients_tpu_torch.training.metrics import detection, to_host


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _model(device):
    model = models.get("yolo_nas_s", num_classes=4, image_size=128, device=device, seed=0)
    for name, module in model.net.named_modules():
        if name.endswith("cls_pred"):
            module.bias.data.zero_()
    return model


def _batches(n=2, b=4):
    ds = RandomDetectionDataset(n * b, (128, 128), 4, 16)
    return list(torch.utils.data.DataLoader(ds, batch_size=b))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["DetectionMetrics", "DetectionMetrics_050", "DetectionMetricsDistanceBased"])
def test_metric_state_on_the_card_equals_the_cpu(variant):
    """The same outputs, on the card and moved to the CPU: equal NMS outputs (K1 on
    the card, its plain version on the CPU) and an equal metric state."""
    _needs_cuda()
    model = _model("cuda")
    metric = detection.__dict__[variant](num_cls=4)
    states = {"cuda": metric.init(), "cpu": metric.init()}
    for images, targets in _batches():
        with torch.inference_mode():
            out = model.net(images.cuda())
        outputs = {"cuda": out, "cpu": type(out)(*(t.cpu() if torch.is_tensor(t) else t for t in out))}
        nms = {}
        for device, o in outputs.items():
            before = nms_exact.exact_nms_keep.launches
            nms[device] = to_host(metric.preprocess_device(o, None))
            assert nms_exact.exact_nms_keep.launches - before == (device == "cuda")
            states[device] = metric.update(states[device], nms[device], targets.numpy())
        for g, r in zip(nms["cuda"], nms["cpu"]):
            assert np.array_equal(g, r)
    for key in ("tp", "conf", "cls", "keep"):
        assert all(np.array_equal(a, b) for a, b in zip(states["cuda"][key], states["cpu"][key])), key
    assert np.array_equal(states["cuda"]["n_gt"], states["cpu"]["n_gt"])
    assert metric.compute(states["cuda"]) == metric.compute(states["cpu"])


@pytest.mark.cuda
def test_evaluate_on_the_card_launches_k1_per_batch(tmp_path, monkeypatch):
    _needs_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    batches = _batches(n=3)
    metrics = [{"DetectionMetrics": {"num_cls": 4}}, {"DetectionMetrics_050": {"num_cls": 4}}]
    params = {"loss": "PPYoloELoss", "criterion_params": {"num_classes": 4}}
    nms_exact.exact_nms_keep.launches = 0
    got = Trainer("cuda_eval", ckpt_root_dir=str(tmp_path)).evaluate(_model("cuda"), batches, params, metrics)
    assert nms_exact.exact_nms_keep.launches == len(batches) * len(metrics)
    ref = Trainer("cpu_eval", ckpt_root_dir=str(tmp_path)).evaluate(_model("cpu"), batches, params, metrics)
    assert set(got) == set(ref) and all(np.isfinite(v) for v in got.values())
    # fp32 forwards of two devices: matches can flip only at threshold-adjacent IoUs
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=2e-2, rtol=1e-3, err_msg=k)
