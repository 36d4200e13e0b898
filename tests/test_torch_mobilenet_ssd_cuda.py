"""MobileNet and SSD on a GPU (``cuda`` marker; each test skips without one). No JAX here: the
CPU tests hold these modules to JAX, and these hold the card to the CPU and K1 to its plain
version on SSD's own candidates. Run on the GPU machine with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_mobilenet_ssd_cuda.py``.
"""

import numpy as np
import pytest
import torch

from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.models import sg_model
from super_gradients_tpu_torch.models.model_factory import _calibrate_batch_norm
from super_gradients_tpu_torch.ops import nms as nms_module
from super_gradients_tpu_torch.ops.kernels import nms_exact
from super_gradients_tpu_torch.training.losses.ssd_loss import SSDLoss

GRID_64 = {"fig_size": 64, "feat_size": [4, 2, 1, 1, 1, 1], "scales": [6, 16, 27, 37, 47, 57, 67],
           "aspect_ratios": [[2, 3]] * 6}


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ssd_pair():
    """(card model, CPU model) of SSD-lite at 64 px, 4 classes, BN statistics on 16 noise images."""
    kw = dict(num_classes=4, image_size=64, arch_params={"heads": {"SSDHead": {"anchors": GRID_64}}}, seed=0)
    cpu = models.get("ssd_lite_mobilenet_v2", device="cpu", **kw)
    _calibrate_batch_norm(cpu.net, torch.Generator().manual_seed(3), (16, 3, 64, 64))
    gpu = models.get("ssd_lite_mobilenet_v2", device="cuda", **kw)
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.net.state_dict().items()})
    return gpu, cpu


@pytest.mark.cuda
def test_ssd_forward_and_predict_on_the_card_match_the_cpu():
    _needs_cuda()
    gpu, cpu = _ssd_pair()
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            g, c = gpu.net(x.cuda()), cpu.net(x)
        for field in ("cls_logits", "reg_distri", "pred_scores", "pred_bboxes"):
            torch.testing.assert_close(getattr(g, field).cpu(), getattr(c, field), atol=1e-3, rtol=1e-3)
        images = [np.random.RandomState(2).randint(0, 256, (48, 64, 3), dtype=np.uint8)]
        nms_exact.exact_nms_keep.launches = 0
        got = gpu.predict(images, conf=0.3, bf16=False, fuse_model=False)
        assert nms_exact.exact_nms_keep.launches == 1
        ref = cpu.predict(images, conf=0.3, bf16=False, fuse_model=False)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert len(got[0]) > 0 and abs(len(got[0]) - len(ref[0])) <= 1


@pytest.mark.cuda
def test_k1_on_ssd_candidates_is_bit_equal_to_the_plain_version():
    _needs_cuda()
    gpu, _ = _ssd_pair()
    batch = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(3)).cuda()
    seen = []
    original = sg_model.batched_nms
    sg_model.batched_nms = lambda *a, **k: seen.append((a, k)) or original(*a, **k)
    try:
        gpu.predict_batch_tensor(batch, conf=0.0)
    finally:
        sg_model.batched_nms = original
    (args, kwargs), = seen
    assert kwargs["scores_are_logits"] is True and args[1].shape[-1] == 5
    captured = []
    keep = nms_module.exact_nms_keep
    nms_module.exact_nms_keep = lambda b, v, t: captured.append((b, v, t)) or keep(b, v, t)
    try:
        with torch.inference_mode():
            nms_module.batched_nms(*args, **kwargs)
    finally:
        nms_module.exact_nms_keep = keep
    boxes, valid, t = captured[0]
    assert torch.equal(nms_exact.exact_nms_keep(boxes, valid, t).cpu(),
                       nms_exact.exact_nms_keep_plain(boxes, valid, t).cpu())


@pytest.mark.cuda
def test_ssd_loss_on_the_card_matches_the_cpu():
    """Matching (argmax ties to the first index), mining (stable sort) and the loss."""
    _needs_cuda()
    from super_gradients_tpu_torch.models.detection.ssd import generate_ssd_anchors
    from super_gradients_tpu_torch.models.detection.yolo_nas import YoloNASOutputs

    anchors = generate_ssd_anchors(64, (4, 2, 1, 1, 1, 1), (6, 16, 27, 37, 47, 57, 67))
    rng = np.random.RandomState(0)
    conf = torch.from_numpy(rng.randn(2, len(anchors), 5).astype(np.float32))
    conf[0] = conf[0, :1]  # equal CEs among image 0's negatives
    loc = torch.from_numpy(rng.randn(2, len(anchors), 4).astype(np.float32))
    t = torch.tensor([[[1, 2.0, 2.0, 10.0, 10.0], [2, 3.0, 3.0, 11.0, 9.0]],
                      [[0, 10.0, 12.0, 50.0, 40.0], [-1, 0, 0, 0, 0]]])
    loss = SSDLoss(anchors_cxcywh=anchors)
    ref, ref_aux = loss(YoloNASOutputs(None, None, conf, loc, None, None, None), t)
    got, got_aux = loss(YoloNASOutputs(None, None, conf.cuda(), loc.cuda(), None, None, None), t.cuda())
    for a, b in zip(loss.match(t.cuda()), loss.match(t)):
        assert torch.equal(a.cpu(), b)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-6)
    for k in ref_aux:
        torch.testing.assert_close(got_aux[k].cpu(), ref_aux[k], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_mobilenet_v3_on_the_card_matches_the_cpu():
    _needs_cuda()
    kw = dict(num_classes=10, arch_params={"width_mult": 0.5}, seed=0)
    gpu, cpu = (models.get("mobilenet_v3_small", device=d, **kw) for d in ("cuda", "cpu"))
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(4))
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            torch.testing.assert_close(gpu.net(x.cuda()).cpu(), cpu.net(x), atol=1e-4, rtol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = True
