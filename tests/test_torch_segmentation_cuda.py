"""The segmentation path on a GPU (``cuda`` marker; each test skips without one). No JAX
here: the CPU tests hold the port's segmentation modules to JAX, and these hold the card to
the CPU, in fp32 with TF32 off. Run on the GPU machine with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_segmentation_cuda.py``.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.models.segmentation.stdc import SeededDropout
from super_gradients_tpu_torch.training.losses import segmentation_losses as losses
from super_gradients_tpu_torch.training.metrics import segmentation as metrics


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@contextlib.contextmanager
def _no_tf32():
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul


def _batch(b=2, hw=(128, 256), c=19, seed=0):
    """Uniform images (the law ``models.get`` calibrates BN on) and targets with void pixels."""
    gen = torch.Generator().manual_seed(seed)
    targets = torch.randint(0, c, (b, *hw), generator=gen)
    targets[torch.rand((b, *hw), generator=gen) < 0.1] = 255
    return torch.rand((b, 3, *hw), generator=gen), targets


@pytest.mark.cuda
@pytest.mark.parametrize("name,arch_params", [("stdc1_seg", {}), ("pp_lite_t_seg", {}),
                                              ("pp_lite_b_seg", {"use_aux_heads": True})])
def test_forward_on_the_card_matches_the_cpu(name, arch_params):
    """Eval and train-mode outputs (dropout off: the devices' generators draw other masks)
    of the same weights within twice the CPU's L2 distance to an fp64 CPU run (over each
    map), or within 1e-5 of that run's L2 norm, whichever is larger: cuDNN's fp32
    convolution algorithms round otherwise than the CPU's, and on these random-init maps
    (logits ~100) the card landed 2.3x the CPU's distance at 5e-6 of the norm (STDC1-Seg,
    eval mode; NVIDIA H100 80GB HBM3)."""
    _needs_cuda()
    cpu = models.get(name, arch_params=arch_params, device="cpu")
    gpu = models.get(name, arch_params=arch_params, device="cuda")
    for net in (cpu.net, gpu.net):
        for m in net.modules():
            if isinstance(m, SeededDropout):
                m.p = 0.0
    x, _ = _batch(b=4)  # at B=2 the BNs on 1x1 maps normalize two values
    ref_net = copy.deepcopy(cpu.net).double()
    for train in (False, True):
        nets = [n.train(train) for n in (gpu.net, cpu.net, ref_net)]
        with _no_tf32(), torch.no_grad():
            g, c, r = nets[0](x.cuda()), nets[1](x), nets[2](x.double())
        for gi, ci, ri in zip(*(o if isinstance(o, tuple) else (o,) for o in (g, c, r))):
            gi, ci = gi.double().cpu(), ci.double()
            e_gpu, e_cpu = float((gi - ri).norm()), float((ci - ri).norm())
            assert e_gpu <= max(2 * e_cpu, 1e-5 * float(ri.norm())), (name, train, e_gpu, e_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", [losses.STDCLoss(), losses.DiceCEEdgeLoss(), losses.OhemCELoss(),
                                  losses.SegCrossEntropyLoss(), losses.DiceLoss()], ids=lambda l: type(l).__name__)
def test_losses_and_gradients_on_the_card_match_the_cpu(loss):
    _needs_cuda()
    _, targets = _batch(c=5)
    gen = torch.Generator().manual_seed(1)
    outputs = [torch.randn((2, 5, 128, 256), generator=gen) * 2 for _ in range(3)] + [torch.randn((2, 1, 128, 256),
                                                                                                 generator=gen)]
    if not isinstance(loss, losses.STDCLoss):
        outputs = outputs[:3] if isinstance(loss, losses.DiceCEEdgeLoss) else outputs[:1]
    values, grads = [], []
    for device in ("cpu", "cuda"):
        ts = [o.detach().to(device).requires_grad_(True) for o in outputs]
        value, _ = loss(tuple(ts) if len(ts) > 1 else ts[0], targets.to(device))
        value.backward()
        values.append(value.item())
        grads.append([t.grad.cpu() for t in ts])
    np.testing.assert_allclose(values[1], values[0], rtol=1e-5)
    for g, c in zip(*grads):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-9)


@pytest.mark.cuda
def test_detail_target_and_confusion_matrix_on_the_card_equal_the_cpu():
    _needs_cuda()
    _, targets = _batch(hw=(97, 131), c=6)
    assert torch.equal(losses.detail_target(targets.cuda()).cpu(), losses.detail_target(targets))
    logits = torch.randn((2, 6, 97, 131), generator=torch.Generator().manual_seed(2))
    for metric in (metrics.IoU(6), metrics.PixelAccuracy(6), metrics.Dice(6)):
        g = metric.update(metric.init(), logits.cuda(), targets.cuda())
        c = metric.update(metric.init(), logits, targets)
        assert g.device.type == "cuda" and torch.equal(g.cpu(), c)
        assert metric.compute(g) == metric.compute(c)


@pytest.mark.cuda
def test_predict_on_the_card_matches_the_cpu():
    """Class maps of 1024x2048 uint8 images at 512x1024: >= 99.9% of pixels equal."""
    _needs_cuda()
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 256, (1024, 2048, 3), dtype=np.uint8) for _ in range(2)]
    gpu, cpu = models.get("pp_lite_t_seg50", device="cuda"), models.get("pp_lite_t_seg50", device="cpu")
    with _no_tf32():
        g = gpu.predict(images, batch_size=2)
    c = cpu.predict(images, batch_size=2)
    for gi, ci in zip(g, c):
        assert gi.segmentation_map.shape == (1024, 2048) and gi.segmentation_map.dtype == ci.segmentation_map.dtype
        assert (gi.segmentation_map == ci.segmentation_map).mean() >= 0.999
