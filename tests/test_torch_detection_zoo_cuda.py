"""PP-YOLOE, YOLOX and sliding-window inference on a GPU (``cuda`` marker; each test skips
without one). No JAX here: the CPU tests hold these modules to JAX, and these hold the
card to the CPU and K1 to its plain version on each path's own candidates. Run on the GPU
machine with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_detection_zoo_cuda.py``.
"""

import pytest
import torch

from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.inference import sliding_window
from super_gradients_tpu_torch.models import sg_model
from super_gradients_tpu_torch.ops import nms as nms_module
from super_gradients_tpu_torch.ops.kernels import nms_exact
from super_gradients_tpu_torch.training.losses import get_loss

NAMES = ("ppyoloe_s", "yolox_n")


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _model(name, device):
    """The variant at 128 px, seed 0, its prediction kernels redrawn from a seeded normal and
    scaled on noise (no letterbox here): PP-YOLOE's class and DFL logits to a standard
    deviation of 2 (class biases 0), YOLOX's class and objectness logits to a largest rise of
    8 above the prior and its size regression to 2 (no saturated score, no box at the exp
    clip)."""
    model = models.get(name, num_classes=4, image_size=128, device=device, seed=0)
    spread = {"pred_cls": ("cls_logits", 2.0), "pred_reg": ("reg_distri", 2.0), "cls_preds": ("cls_logits", 8.0),
              "obj_preds": ("obj_logits", 8.0), "reg_preds": ("reg_raw", 2.0)}
    convs = {k: m for k, m in model.net.named_modules() if len(k.split(".")) > 1 and k.split(".")[-2] in spread}
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for key, module in convs.items():
            module.weight.copy_(torch.randn(module.weight.shape, generator=gen))
            if key.split(".")[-2] == "pred_cls":
                module.bias.zero_()
        out = model.net(torch.rand((2, 3, 128, 128), generator=torch.Generator().manual_seed(9)).to(device))
        for key, module in convs.items():
            field, value = spread[key.split(".")[-2]]
            t = getattr(out, field).float()
            scale = float(t.std()) if name.startswith("ppyoloe") else float((t - module.bias[0]).abs().max())
            module.weight.mul_(value / scale)
    return model


def _matched(got, ref, b, iou_min=0.99):
    """Share of image ``b``'s detections matched one to one (same label, IoU >= iou_min)."""
    from super_gradients_tpu_torch.ops.bbox import box_iou

    n, m = int(got.num_detections[b]), int(ref.num_detections[b])
    if not n or not m:
        return float(n == m)
    ok = (box_iou(got.boxes[b, :n].cpu(), ref.boxes[b, :m].cpu()) >= iou_min) & \
        (got.labels[b, :n].cpu()[:, None] == ref.labels[b, :m].cpu()[None])
    used, matched = set(), 0
    for i in range(n):
        for j in torch.nonzero(ok[i]).flatten().tolist():
            if j not in used:
                used.add(j)
                matched += 1
                break
    return matched / max(n, m)


def _capture(module, name, run):
    seen, original = [], getattr(module, name)
    setattr(module, name, lambda *a, **k: seen.append((a, k)) or original(*a, **k))
    try:
        run()
    finally:
        setattr(module, name, original)
    return seen[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_predict_on_the_card_matches_the_cpu_and_launches_k1(name):
    """fp32 ``predict_batch_tensor`` (TF32 off) on the card and on the CPU: >= 99% of the
    detections matched at IoU 0.99 (``chip_smoke.py`` phase 4's rule); K1 launches once,
    bit-equal to the plain version on the captured candidates."""
    _needs_cuda()
    torch.backends.cudnn.allow_tf32 = False
    try:
        gpu, cpu = _model(name, "cuda"), _model(name, "cpu")
        x = torch.rand((2, 128, 128, 3), generator=torch.Generator().manual_seed(2))
        before = nms_exact.exact_nms_keep.launches
        (args, kwargs) = _capture(sg_model, "batched_nms", lambda: gpu.predict_batch_tensor(x.cuda(), bf16=False, conf=0.05))
        assert nms_exact.exact_nms_keep.launches - before == 1
        assert kwargs["scores_are_logits"] is (name == "ppyoloe_s")
        got = gpu.predict_batch_tensor(x.cuda(), bf16=False, conf=0.05)
        ref = cpu.predict_batch_tensor(x, bf16=False, conf=0.05)
        assert int(ref.num_detections.min()) > 0
        assert min(_matched(got, ref, b) for b in range(2)) >= 0.99
        with torch.inference_mode():
            (boxes, valid, t), _ = _capture(nms_module, "exact_nms_keep", lambda: nms_module.batched_nms(*args, **kwargs))
            assert torch.equal(nms_exact.exact_nms_keep(boxes, valid, t).cpu(),
                               nms_exact.exact_nms_keep_plain(boxes.cpu(), valid.cpu(), t))
    finally:
        torch.backends.cudnn.allow_tf32 = True


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_sliding_window_on_the_card_launches_k1_once_an_image(name, monkeypatch):
    """fp32 tiled inference (TF32 off) on the card against the CPU, matched as above; one K1
    launch for the image's six tiles, bit-equal to the plain version on its candidates."""
    _needs_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gpu, cpu = _model(name, "cuda"), _model(name, "cpu")
    image = torch.rand((300, 420, 3), generator=torch.Generator().manual_seed(3))
    wrappers = [sliding_window.SlidingWindowInferenceDetectionWrapper(m, tile_size=128, tile_step=96,
                                                                      tile_nms_conf=0.05) for m in (gpu, cpu)]
    before = nms_exact.exact_nms_keep.launches
    got = wrappers[0].predict_image_tensor(image.cuda(), bf16=False)
    assert nms_exact.exact_nms_keep.launches - before == 1
    ref = wrappers[1].predict_image_tensor(image, bf16=False)
    assert int(ref.num_detections[0]) > 0 and _matched(got, ref, 0) >= 0.99
    (args, kwargs) = _capture(sliding_window, "batched_nms", lambda: wrappers[0].predict_image_tensor(image.cuda()))
    with torch.inference_mode():
        (boxes, valid, t), _ = _capture(nms_module, "exact_nms_keep", lambda: nms_module.batched_nms(*args, **kwargs))
        assert torch.equal(nms_exact.exact_nms_keep(boxes, valid, t).cpu(),
                           nms_exact.exact_nms_keep_plain(boxes.cpu(), valid.cpu(), t))


@pytest.mark.cuda
def test_yolox_loss_on_the_card_equals_the_cpu():
    """The SimOTA assignment on the card equals the CPU's on the same outputs (stable sorts
    both), and the loss agrees to fp32 rounding."""
    _needs_cuda()
    model = _model("yolox_n", "cpu")
    x = torch.rand((2, 3, 128, 128), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        out = model.net.train()(x)
    gen = torch.Generator().manual_seed(5)
    targets = -torch.ones(2, 8, 5)
    for b in range(2):
        xy = torch.rand(5, 2, generator=gen) * 90
        targets[b, :5] = torch.cat([torch.randint(0, 4, (5, 1), generator=gen).float(), xy,
                                    xy + 8 + torch.rand(5, 2, generator=gen) * 30], 1)
    loss = get_loss("YoloXDetectionLoss", {"num_classes": 4, "use_l1": True})
    cuda_out = type(out)(*(t.cuda() if torch.is_tensor(t) else t for t in out))
    lc, ac = loss(out, targets)
    lg, ag = loss(cuda_out, targets.cuda())
    assert float(ac["num_fg"]) == float(ag["num_fg"]) > 0
    for k in ac:
        torch.testing.assert_close(ag[k].cpu(), ac[k], rtol=1e-5, atol=1e-6)
