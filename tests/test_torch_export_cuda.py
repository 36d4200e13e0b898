"""Export on a GPU (``cuda`` marker; each test skips without one). No JAX here: the CPU tests
hold the exported programs to JAX's, these hold the card's exported program to the live predict
path and K1's op to its plain version. Run on the GPU machine with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_export_cuda.py``.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.export import load_exported
from super_gradients_tpu_torch.ops.kernels import nms_exact


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


class _CaptureK1(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.sg_torch.nms_exact_keep.default:
            self.calls.append((args, out))
        return out


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_exported_detection_program_launches_k1_on_the_card(tmp_path, bf16):
    """``yolo_nas_s`` at 128 px exported with exact NMS: the loaded program launches K1 once a
    call, its keep mask bit-equal to the plain version on the captured candidates, and its
    outputs equal to the live ``predict_batch_tensor``."""
    _needs_cuda()
    model = models.get("yolo_nas_s", num_classes=8, image_size=128, device="cuda")
    for name, module in model.net.named_modules():
        if name.endswith("cls_pred"):
            module.bias.data.zero_()
    path = str(tmp_path / "det.pt2")
    model.export(path, batch_size=2, image_hw=(128, 128), bf16=bf16)
    program = load_exported(path)
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    before = nms_exact.exact_nms_keep.launches
    with _CaptureK1() as capture:
        got = program.call(images)
    torch.cuda.synchronize()
    assert nms_exact.exact_nms_keep.launches - before == 1 and len(capture.calls) == 1
    (boxes, valid, t), keep = capture.calls[0]
    assert boxes.is_cuda and torch.equal(keep.cpu(), nms_exact.exact_nms_keep_plain(boxes.cpu(), valid.cpu(), t))
    live = model.predict_batch_tensor(images.cuda().float() / 255.0, bf16=bf16)
    assert all(torch.equal(a, b) for a, b in zip(got, live))
    assert int(got.num_detections.min()) > 0


@pytest.mark.cuda
def test_k1_op_passes_opcheck_on_cuda_tensors():
    _needs_cuda()
    gen = torch.Generator().manual_seed(1)
    xy = torch.rand((2, 200, 2), generator=gen) * 300
    boxes = torch.cat([xy, xy + torch.rand((2, 200, 2), generator=gen) * 60 + 1], -1).cuda()
    valid = (torch.rand((2, 200), generator=gen) > 0.3).cuda()
    torch.library.opcheck(nms_exact.nms_exact_keep_op, (boxes, valid, 0.5))
