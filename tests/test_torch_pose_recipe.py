"""The YOLO-NAS-POSE recipes of the port against the JAX package's, on the CPU.

- The four pose recipes and their four arch_params files are byte-equal copies, and
  ``load_recipe`` gives the JAX ``load_recipe``'s dict, with overrides and shortcuts.
- End to end at a small size: ``train_from_recipe`` of ``coco2017_yolo_nas_pose_s`` with
  the architecture overridden to YOLO-NAS-POSE-N, 64 px, on a COCO person-keypoints
  dataset of PNGs written here, 1 epoch on the CPU (the recipe's AdamW, threshold EMA,
  bf16, ``YoloNASPoseLoss``, ``PoseEstimationMetrics`` and ``metric_to_watch: AP``);
  then ``evaluate_checkpoint`` (fp32) equals a direct ``Trainer.evaluate`` of
  ``models.get(checkpoint_path=ckpt_best.pth)`` on the recipe's val loader, and
  ``resume_experiment`` takes no step. (TensorBoard is off: it would load TensorFlow here.)
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu_torch import models, train_from_recipe
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.training import Trainer
from test_torch_pose_data import write_pose_coco

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_FILES = [f"coco2017_yolo_nas_pose_{v}.yaml" for v in "nsml"] + \
    [f"arch_params/yolo_nas_pose_{v}_arch_params.yaml" for v in "nsml"]
SIDE = 64


@pytest.mark.parametrize("name", POSE_FILES)
def test_pose_recipe_files_are_byte_equal_copies(name):
    assert filecmp.cmp(os.path.join(REPO, "super_gradients_tpu_torch", "recipes", name),
                       os.path.join(REPO, "super_gradients_tpu", "recipes", name), shallow=False)


@pytest.mark.parametrize("overrides", [[], ["lr=0.003", "batch_size=8", "epochs=3", "ema=False"],
                                       ["dataset_params.train_dataset_params.image_size=[320,320]", "num_classes=17"]])
@pytest.mark.parametrize("variant", ["n", "s", "m", "l"])
def test_load_pose_recipe_equals_jax(variant, overrides):
    name = f"coco2017_yolo_nas_pose_{variant}"
    got = config.load_recipe(name, overrides=overrides)
    assert got == jax_config.load_recipe(name, overrides=overrides)
    tp = got["training_hyperparams"]
    assert got["architecture"] == f"yolo_nas_pose_{variant}" and tp["loss"] == "YoloNASPoseLoss"
    assert tp["metric_to_watch"] == "AP" and got["train_dataloader"] == "coco2017_pose_train"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pose_recipe"))
    write_pose_coco(os.path.join(root, "coco"), "train", 0)
    write_pose_coco(os.path.join(root, "coco"), "val", 1)
    overrides = ["architecture=yolo_nas_pose_n", "device=cpu", "experiment_name=pose_recipe_cpu",
                 f"ckpt_root_dir={root}/ckpt", "epochs=1", "batch_size=2", "val_batch_size=2", "num_workers=0",
                 "training_hyperparams.lr_warmup_steps=0", "training_hyperparams.sg_logger_params.tensorboard=False"]
    for split in ("train", "val"):
        overrides += [f"dataset_params.{split}_dataset_params.data_dir={root}/coco",
                      f"dataset_params.{split}_dataset_params.image_size=[{SIDE},{SIDE}]",
                      f"dataset_params.{split}_dataset_params.json_file=person_keypoints_{split}.json",
                      f"dataset_params.{split}_dataset_params.subdir=images/{split}"]
    model, trainer = train_from_recipe.main(["--config-name=coco2017_yolo_nas_pose_s", *overrides])
    return root, overrides, model, trainer


def test_train_from_pose_recipe(run):
    root, overrides, model, trainer = run
    cfg = config.load_recipe("coco2017_yolo_nas_pose_s", overrides=overrides)
    assert model.device.type == "cpu" and model.name == "yolo_nas_pose_n" and model.num_classes == 17
    assert type(model).__name__ == "PoseEstimationModel"
    assert len(trainer.train_loss_history) == 1 and np.isfinite(trainer.train_loss_history[0])
    assert trainer.train_state.step >= 2
    (valid,) = trainer.valid_metrics_history
    assert set(valid) == {"AP", "AR", "Loss"} and all(np.isfinite(list(valid.values())))
    with open(os.path.join(trainer.ckpt_dir, "recipe.json")) as f:
        assert json.load(f) == cfg
    for name in ("ckpt_latest.pth", "ckpt_best.pth", "average_model.pth"):
        assert os.path.isfile(os.path.join(trainer.ckpt_dir, name))


def test_evaluate_checkpoint_and_resume_of_a_pose_run(run):
    root, overrides, _, trainer = run
    cfg = config.load_recipe("coco2017_yolo_nas_pose_s", overrides=overrides)
    got = Trainer.evaluate_checkpoint("pose_recipe_cpu", ckpt_root_dir=f"{root}/ckpt")
    model = models.get("yolo_nas_pose_n", num_classes=17, image_size=SIDE, device="cpu",
                       checkpoint_path=os.path.join(trainer.ckpt_dir, "ckpt_best.pth"))
    loader = Trainer._loader_from_cfg(cfg, "val")
    direct = Trainer("direct", ckpt_root_dir=f"{root}/direct").evaluate(model, loader, cfg["training_hyperparams"])
    assert set(got) == {"AP", "AR", "Loss"} and got == direct
    _, resumed = Trainer.resume_experiment("pose_recipe_cpu", ckpt_root_dir=f"{root}/ckpt")
    assert resumed.ckpt_dir == trainer.ckpt_dir and resumed.train_loss_history == []
