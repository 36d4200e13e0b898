"""The classification path on a GPU (``cuda`` marker; each test skips without one). No JAX
here: the CPU tests hold the port's classification modules to JAX, and these hold the card
to the CPU, in fp32 with TF32 off. Run on the GPU machine with
``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_classification_cuda.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.training import Trainer, dataloaders
from super_gradients_tpu_torch.training.metrics import get_metric


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


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,), dtype=np.uint8) for hw in ((300, 400), (256, 256), (480, 270))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,size", [("resnet18", 224), ("resnet50", 224), ("resnet18_cifar", 32)])
def test_forward_on_the_card_matches_the_cpu(name, size):
    """Logits of the same weights within twice the CPU's distance to an fp64 CPU run."""
    _needs_cuda()
    gpu, cpu = models.get(name, device="cuda"), models.get(name, device="cpu")
    x = torch.randn(4, 3, size, size, generator=torch.Generator().manual_seed(1))
    with _no_tf32(), torch.no_grad():
        g = gpu.net.eval()(x.cuda()).double().cpu()
        c = cpu.net.eval()(x).double()
        r = cpu.net.double()(x.double())
    assert (g - r).abs().max() <= 2 * (c - r).abs().max() + 1e-6 * r.abs().max()


@pytest.mark.cuda
def test_predict_on_the_card_matches_the_cpu():
    """Top-1 equal on every image; the top-5 probabilities within 1e-4."""
    _needs_cuda()
    gpu, cpu = models.get("resnet50", device="cuda"), models.get("resnet50", device="cpu")
    images = _images()
    with _no_tf32():
        g = gpu.predict(images, batch_size=2)
    c = cpu.predict(images, batch_size=2)
    for pg, pc in zip(g, c):
        assert pg.prediction == pc.prediction
        assert pg.confidence.shape == pc.confidence.shape == (5,)
        np.testing.assert_allclose(pg.confidence, pc.confidence, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_metrics_on_the_card_equal_the_cpu():
    _needs_cuda()
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(64, 10).astype(np.float32))
    logits[:8] = 0.0  # ties: the lowest classes rank first on the card too
    labels = torch.from_numpy(rng.randint(0, 10, 64))
    for name in ("Accuracy", "Top5"):
        metric = get_metric(name)
        on_card = metric.compute(metric.update(metric.init(), logits.cuda(), labels.cuda()))
        on_cpu = metric.compute(metric.update(metric.init(), logits, labels))
        assert on_card == on_cpu


@pytest.mark.cuda
def test_cifar_train_on_the_card(tmp_path):
    """Two epochs of ``resnet18_cifar`` on ``classification_test_dataloader``: finite losses,
    Accuracy and Top5 in the validation results, weights handed back to the model."""
    _needs_cuda()
    model = models.get("resnet18_cifar", device="cuda")
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    loader = dataloaders.get("classification_test_dataloader",
                             dataset_params={"image_size": (32, 32), "dataset_size": 64},
                             dataloader_params={"batch_size": 16})
    trainer = Trainer("cuda_cls", ckpt_root_dir=str(tmp_path))
    trainer.train(model, dict(max_epochs=2, loss="CrossEntropyLoss", criterion_params={"label_smoothing": 0.1},
                              optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 1e-4},
                              zero_weight_decay_on_bias_and_bn=True, initial_lr=0.05, mixed_precision=True,
                              valid_metrics_list=["Accuracy", "Top5"], metric_to_watch="Accuracy", save_model=False,
                              sg_logger_params={"tensorboard": False}), loader, loader)
    assert all(np.isfinite(trainer.train_loss_history))
    assert set(trainer.valid_metrics_history[-1]) == {"Accuracy", "Top5", "Loss"}
    after = model.net.state_dict()
    assert after["linear.weight"].device.type == "cuda"
    assert not torch.equal(after["linear.weight"], before["linear.weight"])
