"""The Cityscapes segmentation recipes and callbacks of the port, on the CPU.

- The five recipe files are byte-equal copies of the JAX package's, and ``load_recipe``
  gives the JAX ``load_recipe``'s dict.
- End to end at a small size: ``train_from_recipe`` of ``cityscapes_pplite_seg50``
  (PP-LiteSeg-T, ``DiceCEEdgeLoss``, EMA) and ``cityscapes_stdc_base`` (STDC1-Seg,
  ``STDCLoss``) at the published widths on a Cityscapes-layout tree written by
  ``tools/cityscapes_synthetic.py`` (8 + 4 images, every trainId and void), at
  ``image_size`` 64x128 (of 512x1024), 2 epochs (of 200 / 800) of b4. Every loss is
  finite, ``IoU`` and ``PixelAccuracy`` are reported, ``evaluate_checkpoint`` is within 1e-6
  of a direct ``Trainer.evaluate`` of ``models.get(checkpoint_path=ckpt_best.pth)``, and
  ``evaluate_from_recipe`` and ``resume_experiment`` run from the run's ``recipe.json``.
- The segmentation visualization callbacks draw the trained network's class maps (JAX's
  drawing, byte for byte) into the logger; ``SlidingWindowValidationCallback`` still raises,
  naming 'Predict-path leftovers'.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu.inference import prediction_results as jax_results
from super_gradients_tpu_torch import evaluate_from_recipe, models, train_from_recipe
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.training import RandomSegmentationDataset, Trainer, callbacks
from tools.cityscapes_synthetic import write_cityscapes_tree

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ["cityscapes_pplite_seg50", "cityscapes_pplite_seg75", "cityscapes_stdc_base", "cityscapes_stdc_seg50",
           "cityscapes_stdc_seg75"]
TOL = 1e-6


@pytest.mark.parametrize("name", RECIPES)
def test_segmentation_recipe_files_are_byte_equal_copies(name):
    assert filecmp.cmp(os.path.join(REPO, "super_gradients_tpu_torch", "recipes", f"{name}.yaml"),
                       os.path.join(REPO, "super_gradients_tpu", "recipes", f"{name}.yaml"), shallow=False)


@pytest.mark.parametrize("name", RECIPES)
def test_load_segmentation_recipe_equals_jax(name):
    got = config.load_recipe(name, overrides=["epochs=2", "batch_size=4"])
    assert got == jax_config.load_recipe(name, overrides=["epochs=2", "batch_size=4"])
    assert got["num_classes"] == 19 and got["training_hyperparams"]["lr_mode"] == "PolyLRScheduler"


@pytest.fixture(scope="module")
def cityscapes_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes"))
    write_cityscapes_tree(root, train=8, val=4, height=96, width=192, seed=7)
    return root


def _overrides(root, experiment):
    return ["device=cpu", f"experiment_name={experiment}", f"ckpt_root_dir={root}/ckpt", "epochs=2", "batch_size=4",
            "val_batch_size=4", "num_workers=0", f"dataset_params.train_dataset_params.root={root}",
            f"dataset_params.val_dataset_params.root={root}", "dataset_params.train_dataset_params.image_size=[64,128]",
            "dataset_params.val_dataset_params.image_size=[64,128]",
            "training_hyperparams.sg_logger_params.tensorboard=False"]


@pytest.fixture(scope="module", params=["cityscapes_pplite_seg50", "cityscapes_stdc_base"])
def run(request, cityscapes_root):
    overrides = _overrides(cityscapes_root, request.param + "_cpu")
    model, trainer = train_from_recipe.main([f"--config-name={request.param}", *overrides])
    return request.param, overrides, model, trainer


def test_train_from_recipe(run):
    name, overrides, model, trainer = run
    cfg = config.load_recipe(name, overrides=overrides)
    assert model.device.type == "cpu" and type(model).__name__ == "SegmentationModel"
    assert model.name == cfg["architecture"] == ("pp_lite_t_seg50" if "pplite" in name else "stdc1_seg")
    assert trainer.train_state.step == 2 * 2
    assert len(trainer.train_loss_history) == 2 and all(np.isfinite(trainer.train_loss_history))
    assert all(set(v) == {"PixelAccuracy", "IoU", "Loss"} for v in trainer.valid_metrics_history)
    assert all(np.isfinite(list(v.values())).all() for v in trainer.valid_metrics_history)
    assert trainer.best_metric == max(v["IoU"] for v in trainer.valid_metrics_history)
    assert trainer.unconsumed_training_params == []
    with open(os.path.join(trainer.ckpt_dir, "recipe.json")) as f:
        assert json.load(f) == cfg
    for ckpt in ("ckpt_latest.pth", "ckpt_best.pth", "average_model.pth"):
        assert os.path.isfile(os.path.join(trainer.ckpt_dir, ckpt))


def test_evaluate_checkpoint_from_recipe_and_resume(run, cityscapes_root):
    name, overrides, _, trainer = run
    cfg = config.load_recipe(name, overrides=overrides)
    root = f"{cityscapes_root}/ckpt"
    got = Trainer.evaluate_checkpoint(cfg["experiment_name"], ckpt_root_dir=root)
    model = models.get(cfg["architecture"], num_classes=19, device="cpu",
                       checkpoint_path=os.path.join(trainer.ckpt_dir, "ckpt_best.pth"))
    loader = Trainer._loader_from_cfg(cfg, "val")
    direct = Trainer("direct", ckpt_root_dir=f"{cityscapes_root}/direct").evaluate(model, loader,
                                                                                 cfg["training_hyperparams"])
    assert set(got) == set(direct) == {"PixelAccuracy", "IoU", "Loss"}
    assert all(abs(got[k] - direct[k]) <= TOL for k in got), (got, direct)
    from_recipe = evaluate_from_recipe.main([f"--config-name={name}",
                                             f"--checkpoint-path={trainer.ckpt_dir}/ckpt_best.pth", *overrides])
    assert all(abs(from_recipe[k] - direct[k]) <= TOL for k in direct)
    step = trainer.train_state.step
    _, resumed = Trainer.resume_experiment(cfg["experiment_name"], ckpt_root_dir=root)
    assert resumed.ckpt_dir == trainer.ckpt_dir and resumed.train_loss_history == []
    assert resumed.train_state.step == step


def test_recipe_regime_reaches_the_model(run):
    """The recipes' SGD, zero weight decay on bias and BN, and EMA."""
    name, _, _, trainer = run
    state = trainer.train_state
    assert type(state.optimizer).__name__ == "SGD"
    decayed = [g for g in state.optimizer.param_groups if g["weight_decay"] > 0]
    assert decayed and all(p.ndim >= 2 for g in decayed for p in g["params"])
    assert state.ema is not None


# ------------------------------------------------------------------ callbacks


def _loader(n, hw=(64, 64)):
    return torch.utils.data.DataLoader(RandomSegmentationDataset(n, hw, 3, seed=1), batch_size=2)


def test_segmentation_visualization_callbacks_write_jax_drawings(tmp_path, monkeypatch):
    """In ``Trainer.train``: the validation batch's and the extreme train batch's class maps
    by the epoch's trained network, drawn as JAX draws them, reach ``add_image`` (PNG files)."""
    model = models.get("pp_lite_t_seg", num_classes=3, input_hw=(64, 64), device="cpu")
    sent = []
    from super_gradients_tpu_torch.common import sg_loggers

    original = sg_loggers.BaseSGLogger.add_image

    def add_image(self, tag, image, step=0):
        sent.append((tag, image))
        return original(self, tag, image, step)

    monkeypatch.setattr(sg_loggers.BaseSGLogger, "add_image", add_image)
    trainer = Trainer("seg_visualize", ckpt_root_dir=str(tmp_path))
    params = dict(max_epochs=1, loss="DiceCEEdgeLoss", criterion_params={"num_classes": 3}, initial_lr=1e-3,
                  valid_metrics_list=[{"IoU": {"num_classes": 3}}], metric_to_watch="IoU", save_model=False,
                  sg_logger_params={"tensorboard": False},
                  phase_callbacks=[{"SegmentationVisualizationCallback": {"max_images": 2}},
                                   {"ExtremeBatchSegVisualizationCallback": {"max_images": 1}}])
    trainer.train(model, params, _loader(4), _loader(4))
    tags = [t for t, _ in sent]  # the extreme train batch is drawn at the train loader's end
    assert tags[0].startswith("extreme_batch_max_loss/img0 (loss=") and len(tags) == 3
    assert tags[1:] == ["valid_segmentation/img0", "valid_segmentation/img1"]
    images = next(iter(_loader(4)))[0][:2]
    with torch.no_grad():
        masks = model.net.eval()(images).argmax(dim=1).numpy()
    for j, (_, drawn) in enumerate(sent[1:]):
        img = images[j].permute(1, 2, 0).numpy()
        img_u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        ref = jax_results.SegmentationPrediction(segmentation_map=masks[j], image=img_u8).draw(alpha=0.5)
        np.testing.assert_array_equal(drawn, ref)
    assert len(os.listdir(os.path.join(trainer.ckpt_dir, "images"))) == 3


def test_segmentation_callbacks_resolve_and_sliding_window_waits():
    """The segmentation callbacks, (since the detection zoo slice) the sliding-window validation
    and (since the export slice) the export check resolve; no callback name is left unported."""
    for name in ("SegmentationVisualizationCallback", "ExtremeBatchSegVisualizationCallback",
                 "SlidingWindowValidationCallback", "ModelConversionCheckCallback"):
        assert type(callbacks.resolve_callback({name: {}})).__name__ == name
    assert callbacks.NOT_PORTED == {}
