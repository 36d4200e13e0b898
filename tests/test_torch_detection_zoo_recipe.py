"""The PP-YOLOE and YOLOX recipes of the port against the JAX package's, on the CPU.

- The seven recipes and the arch_params files of both families are byte-equal copies of
  the JAX package's, and ``load_recipe`` gives the JAX ``load_recipe``'s dict.
- ``roboflow_yolox`` and ``roboflow_ppyoloe`` train through ``train_from_recipe`` at a
  small size (YOLOX-N and PP-YOLOE-S at width 0.25, 64 px, 4 classes, 8 train and 8
  valid PNGs, 2 epochs of 2 steps), with the families' stage switches cut to epoch 1:
  ``YoloXTrainingStageSwitchCallback`` closes the mosaic and mixup and turns ``use_l1``
  on; ``PPYoloETrainingStageSwitchCallback`` moves ``PPYoloELoss`` from ATSS to TAL.
  Every loss and metric is finite and ``evaluate_checkpoint`` gives the validation of
  its checkpoint's epoch back.
- One step of each recipe's criterion held to JAX: the JAX model's weights carried to
  the port, one validation batch of the recipe's loader, the train-mode forward and the
  recipe's loss (YOLOX with and without ``use_l1``, PP-YOLOE with ATSS and with TAL):
  every loss component to ``rtol=1e-4``, and the gradient of each prediction conv's
  weight, what the step moves first, within 1% of its L2 norm (the two fp32 train-mode
  forwards of a random-init net part by ~1e-3 there; both libraries alike, see the
  train-step tests).
"""

import filecmp
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu.training.losses import get_loss as jax_get_loss
from super_gradients_tpu_torch import evaluate_checkpoint, models, train_from_recipe
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.conversion.from_jax import PPYOLOE_RULES, YOLOX_RULES, variables_from_jax_to_torch
from super_gradients_tpu_torch.training import callbacks, dataloaders
from super_gradients_tpu_torch.training.losses import PPYoloELoss, YoloXDetectionLoss, get_loss
from test_torch_detection_transforms import smooth_image
from test_torch_ppyoloe_model import numpy_variables
from test_torch_recipes import NUM_CLASSES, SIDE, _write_split

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ["coco2017_ppyoloe_s", "coco2017_ppyoloe_m", "coco2017_ppyoloe_l", "coco2017_ppyoloe_x", "coco2017_yolox",
           "roboflow_ppyoloe", "roboflow_yolox"]
ARCH_PARAMS = [f"arch_params/{n}_arch_params.yaml" for n in
               ("ppyoloe_s", "ppyoloe_m", "ppyoloe_l", "ppyoloe_x", "yolox_nano", "yolox_tiny", "yolox_s", "yolox_m",
                "yolox_l", "yolox_x", "yolo")]
PPYOLOE_AP = {"width_mult": 0.25, "depth_mult": 0.33}


@pytest.mark.parametrize("name", [f"{r}.yaml" for r in RECIPES] + ARCH_PARAMS)
def test_recipe_files_are_byte_equal_copies(name):
    assert filecmp.cmp(os.path.join(REPO, "super_gradients_tpu_torch", "recipes", name),
                       os.path.join(REPO, "super_gradients_tpu", "recipes", name), shallow=False)


@pytest.mark.parametrize("overrides", [[], ["architecture=yolox_n", "batch_size=8", "epochs=3", "num_classes=5"]])
@pytest.mark.parametrize("name", RECIPES)
def test_load_recipe_equals_jax(name, overrides):
    cfg = config.load_recipe(name, overrides=overrides)
    assert cfg == jax_config.load_recipe(name, overrides=overrides)
    assert cfg["training_hyperparams"]["loss"] in ("PPYoloELoss", "YoloXDetectionLoss")


def _dataset(root):
    rng = np.random.RandomState(0)
    for split in ("train", "valid"):
        images = [smooth_image(rng, SIDE, SIDE) for _ in range(8)]
        boxes = []
        for _ in range(8):
            xy = rng.uniform(0, 40, (3, 2))
            boxes.append((np.concatenate([xy, xy + rng.uniform(8, 24, (3, 2))], 1), rng.randint(0, NUM_CLASSES, 3)))
        _write_split(os.path.join(root, "rf100", "tiny", split), images, boxes)


def _overrides(root, name):
    out = ["device=cpu", f"num_classes={NUM_CLASSES}", "dataset_name=tiny", f"experiment_name={name}_cpu",
           f"ckpt_root_dir={root}/ckpt", "epochs=2", "batch_size=4", "val_batch_size=4", "num_workers=0",
           "training_hyperparams.lr_warmup_epochs=0", "training_hyperparams.sg_logger_params.tensorboard=False"]
    for split in ("train", "val"):
        out += [f"dataset_params.{split}_dataset_params.data_dir={root}/rf100",
                f"dataset_params.{split}_dataset_params.image_size=[{SIDE},{SIDE}]"]
    if name == "roboflow_yolox":
        out += ["architecture=yolox_n",
                "training_hyperparams.phase_callbacks=[{YoloXTrainingStageSwitchCallback: {next_stage_start_epoch: 1}}]"]
    else:
        out += ["architecture=ppyoloe_s", "arch_params.width_mult=0.25", "arch_params.depth_mult=0.33",
                "training_hyperparams.criterion_params.use_static_assigner=True",
                "training_hyperparams.phase_callbacks=[{PPYoloETrainingStageSwitchCallback: {static_assigner_end_epoch: 1}}]"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both recipe runs; the loaders the YOLOX stage switch closed and the switch flag of
    every criterion call (train steps and validation batches, in order), recorded on the way."""
    root = str(tmp_path_factory.mktemp("zoo_recipe"))
    _dataset(root)
    closed, flags = [], []
    close = callbacks._close_multisample_transforms
    mp = pytest.MonkeyPatch()
    mp.setattr(callbacks, "_close_multisample_transforms", lambda loader: closed.append(loader) or close(loader))
    for cls, flag in ((YoloXDetectionLoss, "use_l1"), (PPYoloELoss, "use_static_assigner")):
        mp.setattr(cls, "__call__", (lambda call, flag: lambda self, *a: flags.append(getattr(self, flag)) or call(self, *a))(
            cls.__call__, flag))
    try:
        out = {}
        for name in ("roboflow_yolox", "roboflow_ppyoloe"):
            model, trainer = train_from_recipe.main([f"--config-name={name}", *_overrides(root, name)])
            out[name] = (model, trainer, list(flags))
            flags.clear()
    finally:
        mp.undo()
    return root, out, closed


def _finite_history(trainer):
    assert len(trainer.train_loss_history) == 2 and all(math.isfinite(v) for v in trainer.train_loss_history)
    for metrics in trainer.valid_metrics_history:
        assert metrics and all(math.isfinite(float(v)) for v in metrics.values())


def test_yolox_recipe_trains_and_switches_stage(runs):
    root, out, closed = runs
    model, trainer, flags = out["roboflow_yolox"]
    _finite_history(trainer)
    assert trainer.training_params["criterion_params"]["use_l1"] is True
    # epoch 0's two steps without the L1 term, epoch 1's with it (validation calls between)
    assert flags[:2] == [False, False] and flags[-2:] == [True, True] and flags == sorted(flags)
    (loader,) = closed
    names = {type(t).__name__: t.prob for t in loader.dataset.transforms.transforms if hasattr(t, "prob")}
    assert names["DetectionMosaic"] == names["DetectionMixup"] == 0.0 and names["DetectionHorizontalFlip"] == 0.5
    assert type(model.net).__name__ == "YoloX"


def test_ppyoloe_recipe_trains_and_switches_assigner(runs):
    _, out, _ = runs
    model, trainer, flags = out["roboflow_ppyoloe"]
    _finite_history(trainer)
    assert trainer.training_params["criterion_params"]["use_static_assigner"] is False
    assert flags[:2] == [True, True] and flags[-2:] == [False, False] and flags == sorted(flags, reverse=True)
    assert type(model.net).__name__ == "PPYoloE" and model.config.width_mult == 0.25


@pytest.mark.parametrize("name", ["roboflow_yolox", "roboflow_ppyoloe"])
def test_evaluate_checkpoint_gives_the_validation_of_its_epoch(runs, name):
    """``ckpt_best`` (epoch 0: no later epoch beat its mAP) evaluated again equals that
    epoch's validation, its Loss included: the recipe's criterion before the switch."""
    root, out, _ = runs
    _, trainer, _ = out[name]
    assert torch.load(os.path.join(trainer.ckpt_dir, "ckpt_best.pth"), weights_only=False)["epoch"] == 0
    evaluated = evaluate_checkpoint.main([f"--experiment-name={name}_cpu", f"--ckpt-root-dir={root}/ckpt"])
    assert evaluated == trainer.valid_metrics_history[0]


def _batch(root):
    loader = dataloaders.get("roboflow_val", dataset_params={"data_dir": f"{root}/rf100", "dataset_name": "tiny",
                                                             "image_size": [SIDE, SIDE], "batch_size": 4})
    images, targets = next(iter(loader))
    return (images.float() * float(np.float32(1 / 255.0))).numpy(), targets.numpy()


@pytest.mark.parametrize("case", ["yolox", "yolox_l1", "ppyoloe_atss", "ppyoloe_tal"])
def test_one_step_of_the_recipe_criterion_matches_jax(runs, case):
    root, _, _ = runs
    images, targets = _batch(root)
    family = "yolox" if case.startswith("yolox") else "ppyoloe"
    name, ap, rules = ("yolox_n", {}, YOLOX_RULES) if family == "yolox" else ("ppyoloe_s", PPYOLOE_AP, PPYOLOE_RULES)
    cp = {"num_classes": NUM_CLASSES, **({"use_l1": case == "yolox_l1"} if family == "yolox" else
                                        {"use_static_assigner": case == "ppyoloe_atss"})}
    loss_name = "YoloXDetectionLoss" if family == "yolox" else "PPYoloELoss"
    jm = jax_models.get(name, num_classes=NUM_CLASSES, image_size=SIDE, arch_params=ap)
    v = numpy_variables(jm)
    pm = models.get(name, num_classes=NUM_CLASSES, image_size=SIDE, device="cpu", arch_params=ap)
    pm.net.load_state_dict(variables_from_jax_to_torch(v, rules), strict=True)

    jloss = jax_get_loss(loss_name, cp)

    def jax_loss(params):
        out, _ = jm.module.apply({**jm.variables, "params": params}, jnp.asarray(images.transpose(0, 2, 3, 1)),
                                 train=True, mutable=["batch_stats"])
        return jloss(out, jnp.asarray(targets))

    (jv, jaux), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jm.variables["params"])
    net = pm.net.train()
    pv, paux = get_loss(loss_name, cp)(net(torch.from_numpy(images)), torch.from_numpy(targets))
    pv.backward()
    assert sorted(paux) == sorted(jaux)
    np.testing.assert_allclose(pv.item(), float(jv), rtol=1e-4)
    for k in jaux:
        np.testing.assert_allclose(paux[k].item(), float(jaux[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    # the gradients of the prediction convs, which the zero-kernel PP-YOLOE init trains first
    port_grads = {k: p.grad for k, p in net.named_parameters()}
    jflat = variables_from_jax_to_torch({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, rules)
    heads = [k for k in jflat if ("pred" in k) and k.endswith("weight")]
    assert heads
    moved = 0
    for k in heads:  # a level without positives gets no box gradient in either package
        g, r = port_grads[k].numpy(), jflat[k].numpy()
        assert np.linalg.norm(g - r) <= 1e-2 * np.linalg.norm(r), (k, np.linalg.norm(g - r), np.linalg.norm(r))
        moved += np.linalg.norm(r) > 0
    assert moved >= len(heads) // 2


class _ProbDataset(torch.utils.data.Dataset):
    """Each sample is the mosaic's probability as a worker's copy of the dataset sees it."""

    def __init__(self):
        from super_gradients_tpu_torch.training.transforms.detection import DetectionMosaic

        self.transforms = type("Compose", (), {"transforms": [DetectionMosaic(prob=1.0)]})()

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return torch.tensor(self.transforms.transforms[0].prob)


def test_stage_switch_reaches_persistent_workers():
    """Persistent loader workers hold the dataset as it was when they started: closing the
    mosaic restarts them, so the next epoch's samples come from the closed transforms."""
    loader = dataloaders.DataLoader(_ProbDataset(), batch_size=2, num_workers=2, drop_last=False)
    try:
        assert torch.cat(list(loader)).tolist() == [1.0] * 4
        assert callbacks._close_multisample_transforms(loader) == 1
        assert torch.cat(list(loader)).tolist() == [0.0] * 4
    finally:
        loader.restart_workers()
