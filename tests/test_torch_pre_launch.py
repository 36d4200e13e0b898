"""The port's ``AutoTrainBatchSizeSelectionCallback`` against the JAX package's, on the
CPU, with one injected memory probe for both: the same doubling ladder, the same stop
(over the budget, or no reading), the same batch and linearly scaled LR written into the
recipe. The port's own probe (a real forward and backward, read from
``torch.cuda.max_memory_allocated``) runs on the card only: on the CPU it reads None
(``tests/test_torch_train_cuda.py`` holds it on a GPU)."""

import copy

import pytest
import torch

from super_gradients_tpu.training import pre_launch_callbacks as jax_plc
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.training import pre_launch_callbacks as plc
from super_gradients_tpu_torch.training.losses import get_loss

RECIPE = {"dataset_params": {"train_dataloader_params": {"batch_size": 16}},
          "training_hyperparams": {"initial_lr": 4e-4, "max_epochs": 3}}


def _probe(limit_bs, per_image_gb=0.5):
    """A probe with a fixed cost a sample, reading None (out of memory) above ``limit_bs``."""
    calls = []

    def probe(model, batch_size, image_hw, loss_fn):
        calls.append(batch_size)
        return None if batch_size > limit_bs else 1.0 + per_image_gb * batch_size

    return probe, calls


@pytest.mark.parametrize("kwargs,limit_bs", [(dict(), 10 ** 6), (dict(hbm_budget_gb=14.0), 64),
                                             (dict(min_batch_size=4, max_batch_size=64, hbm_budget_gb=80.0), 16),
                                             (dict(min_batch_size=8, max_batch_size=64, hbm_budget_gb=80.0), 10 ** 6),
                                             (dict(scale_lr=False, hbm_budget_gb=40.0), 10 ** 6)])
def test_ladder_and_lr_scaling_equal_jax(monkeypatch, kwargs, limit_bs):
    jax_probe, jax_calls = _probe(limit_bs)
    port_probe, port_calls = _probe(limit_bs)
    monkeypatch.setattr(jax_plc, "estimate_train_step_memory_gb", jax_probe)
    monkeypatch.setattr(plc, "estimate_train_step_memory_gb", port_probe)
    ref = jax_plc.AutoTrainBatchSizeSelectionCallback(**kwargs)(copy.deepcopy(RECIPE), model=object(),
                                                                  loss_fn=object(), image_hw=(64, 64))
    got = plc.AutoTrainBatchSizeSelectionCallback(**kwargs)(copy.deepcopy(RECIPE), model=object(), loss_fn=object(),
                                                            image_hw=(64, 64))
    assert got == ref and port_calls == jax_calls
    chosen = got["dataset_params"]["train_dataloader_params"]["batch_size"]
    lr = got["training_hyperparams"]["initial_lr"]
    assert lr == (4e-4 * chosen / 16 if kwargs.get("scale_lr", True) else 4e-4)


def test_recipe_alone_is_handed_back_and_the_input_kept(monkeypatch):
    """Called with the recipe alone (as the trainer calls it), nothing is probed."""
    probe, calls = _probe(64)
    monkeypatch.setattr(plc, "estimate_train_step_memory_gb", probe)
    recipe = copy.deepcopy(RECIPE)
    cb = plc.AutoTrainBatchSizeSelectionCallback()
    out = cb(recipe)
    assert out == RECIPE and out is not recipe and calls == []
    cb(recipe, model=object(), loss_fn=object())
    assert recipe == RECIPE and calls  # probed, and the recipe passed in left as it was


def test_probe_reads_none_on_the_cpu():
    model = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu")
    loss = get_loss("PPYoloELoss", {"num_classes": 4})
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    assert plc.estimate_train_step_memory_gb(model, 2, (64, 64), lambda out, t: loss(out, t)) is None
    assert all(torch.equal(before[k], v) for k, v in model.net.state_dict().items())
    # with the probe reading None at once, the ladder keeps the smallest batch
    cfg = plc.AutoTrainBatchSizeSelectionCallback(min_batch_size=8)(copy.deepcopy(RECIPE), model=model,
                                                                    loss_fn=loss, image_hw=(64, 64))
    assert cfg["dataset_params"]["train_dataloader_params"]["batch_size"] == 8
    assert cfg["training_hyperparams"]["initial_lr"] == 4e-4 * 8 / 16
