"""The ``coco_segmentation_shelfnet_lw`` and ``supervisely_unet`` recipes of the port on the CPU,
the device the entry points choose, and a one-class model's ``predict()``.

- Each recipe trains one epoch of two steps through ``train_from_recipe`` on its seeded tree
  (``tools/segmentation_synthetic.py``: four train and two val 96x80 images, read at 64x64 in
  batches of 2; ``chip_smoke.py``'s phase 20(c) runs the same code at the recipe's own size and
  batch on the card), on the CPU (``device=cpu``): finite losses,
  every parameter changed, the recipe's metrics reported. ``evaluate_checkpoint.main`` of the
  run equals a direct ``Trainer.evaluate`` of ``models.get(checkpoint_path=ckpt_best.pth)``
  within 1e-6, and ``resume_experiment.main`` takes no step.
- ``setup_device()`` no longer chooses the CPU by itself: without CUDA it raises naming
  ``device='cpu'``, launched or not, and ``device="cpu"`` works. The two CLIs pass
  ``setup_device`` the device of the run's ``recipe.json`` (the GPU where it names none).
- A one-class model's ``predict()`` takes the argmax over its single channel, so every pixel is
  class 0, in both packages (``supervisely_unet``'s UNet; a fault of the JAX package kept in the
  port, ROADMAP.md section 3).
"""

import json
import os

import numpy as np
import pytest
import torch

from super_gradients_tpu_torch import evaluate_checkpoint, models, resume_experiment, train_from_recipe
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.parallel import mesh
from super_gradients_tpu_torch.training import Trainer
from tools.segmentation_synthetic import RECIPE_TREES, recipe_cuts, write_recipe_tree
from torch_jax_init import jax_model

torch.set_num_threads(2)

EVAL_TOL = 1e-6
RECIPES = tuple(RECIPE_TREES)


@pytest.fixture(scope="module")
def recipe_runs(tmp_path_factory):
    """Both recipes trained once: {recipe: (cfg, trainer, initial parameters, ckpt root)}."""
    root = tmp_path_factory.mktemp("shelf_recipes")
    runs = {}
    for recipe in RECIPES:
        ckpt_root = str(root / "ckpt")
        data_root = write_recipe_tree(recipe, str(root / "data"), train=4, val=2, height=96, width=80)
        cuts = recipe_cuts(recipe, data_root, ckpt_root, batch=2, image_size=(64, 64), device="cpu")
        cfg = config.load_recipe(recipe, overrides=cuts)
        initial = {k: v.detach().clone() for k, v in models.get(
            cfg["architecture"], num_classes=cfg["num_classes"], device="cpu").net.named_parameters()}
        _, trainer = train_from_recipe.main([f"--config-name={recipe}", *cuts])
        runs[recipe] = (cfg, trainer, initial, ckpt_root)
    return runs


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_trains_one_epoch_on_the_cpu(recipe_runs, recipe):
    cfg, trainer, initial, _ = recipe_runs[recipe]
    assert trainer.train_state.step == 2 and len(trainer.train_loss_history) == 1
    assert np.isfinite(trainer.train_loss_history).all()
    live = dict(trainer.train_state.net.named_parameters())
    assert [k for k, v in initial.items() if torch.equal(v, live[k])] == []
    (valid,) = trainer.valid_metrics_history
    want = {"coco_segmentation_shelfnet_lw": {"PixelAccuracy", "IoU", "Loss"}, "supervisely_unet": {"BinaryIoU", "Loss"}}
    assert set(valid) == want[recipe] and np.isfinite(list(valid.values())).all()
    with open(os.path.join(trainer.ckpt_dir, "recipe.json")) as f:
        assert json.load(f)["device"] == "cpu"


@pytest.mark.parametrize("recipe", RECIPES)
def test_evaluate_checkpoint_equals_trainer_evaluate(recipe_runs, recipe, monkeypatch):
    """``evaluate_checkpoint.main`` on the run's recipe device (recorded) equals a direct
    ``Trainer.evaluate`` of the best checkpoint; ``resume_experiment.main`` takes no step."""
    cfg, trainer, _, ckpt_root = recipe_runs[recipe]
    devices = []
    real = mesh.setup_device
    monkeypatch.setattr(mesh, "setup_device", lambda **kw: devices.append(kw.get("device")) or real(**kw))
    evaluated = evaluate_checkpoint.main([f"--experiment_name={cfg['experiment_name']}", f"--ckpt_root_dir={ckpt_root}"])
    model = models.get(cfg["architecture"], num_classes=cfg["num_classes"], device="cpu",
                       checkpoint_path=os.path.join(trainer.ckpt_dir, "ckpt_best.pth"))
    direct = Trainer("direct", ckpt_root_dir=ckpt_root).evaluate(model, Trainer._loader_from_cfg(cfg, "val"),
                                                                 cfg["training_hyperparams"])
    assert set(evaluated) == set(direct)
    for k in direct:
        assert abs(evaluated[k] - direct[k]) <= EVAL_TOL * (abs(direct[k]) if k == "Loss" else 1.0), k
    _, resumed = resume_experiment.main([f"--experiment_name={cfg['experiment_name']}", f"--ckpt_root_dir={ckpt_root}"])
    assert resumed.train_loss_history == [] and resumed.train_state.step == trainer.train_state.step
    assert devices == ["cpu", "cpu"]


def test_setup_device_does_not_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for launched in (False, True):
        for var in ("WORLD_SIZE", "RANK"):
            if launched:
                monkeypatch.setenv(var, "1" if var == "WORLD_SIZE" else "0")
            else:
                monkeypatch.delenv(var, raising=False)
        for kw in ({}, {"device": "cuda"}, {"device": None}):
            with pytest.raises(RuntimeError, match=r"CUDA is not available; pass device='cpu'"):
                mesh.setup_device(**kw)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    assert mesh.setup_device(device="cpu").device == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_clis_take_the_device_of_the_run_recipe(recipe_runs, monkeypatch):
    """A run whose ``recipe.json`` names no device is reopened on the GPU, which raises here."""
    cfg, trainer, _, ckpt_root = recipe_runs["supervisely_unet"]
    path = os.path.join(trainer.ckpt_dir, "recipe.json")
    with open(path) as f:
        recipe = json.load(f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with open(path, "w") as f:
            json.dump({k: v for k, v in recipe.items() if k != "device"}, f)
        args = [f"--experiment_name={cfg['experiment_name']}", f"--ckpt_root_dir={ckpt_root}"]
        for cli in (evaluate_checkpoint, resume_experiment):
            with pytest.raises(RuntimeError, match=r"setup_device\(\.\.\., device='cuda'\): CUDA is not available"):
                cli.main(args)
    finally:
        with open(path, "w") as f:
            json.dump(recipe, f)


def test_one_class_predict_maps_every_pixel_to_zero_in_both_packages():
    """``supervisely_unet``'s UNet has one output channel; ``predict()`` takes its argmax."""
    image = np.random.RandomState(0).randint(0, 256, (48, 40, 3), dtype=np.uint8)
    port = models.get("unet", num_classes=1, input_hw=(32, 32), device="cpu")
    ref = jax_model("unet", num_classes=1, input_hw=(32, 32))
    with torch.no_grad():
        logits = port.net.eval()(torch.rand(1, 3, 32, 32))
    assert logits.shape == (1, 1, 32, 32) and float(logits.std()) > 0
    for model in (port, ref):
        (pred,) = list(model.predict([image]))
        assert pred.segmentation_map.shape == (48, 40) and not pred.segmentation_map.any()
