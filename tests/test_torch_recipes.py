"""Recipes and the recipe entry points of the port against the JAX package's, on the CPU.

- The six YAML files the YOLO-NAS recipes compose are byte-equal to the JAX package's,
  and ``load_recipe`` gives the JAX ``load_recipe``'s dict, with overrides and shortcuts.
  Without PyYAML it raises an ``ImportError`` that names it.
- End to end at a small size: ``train_from_recipe`` of ``roboflow_yolo_nas_m`` with the
  architecture overridden to YOLO-NAS-S, 64 px, 4 classes, 8 train and 8 valid PNGs,
  1 epoch on the CPU; then ``resume_experiment`` (no step, the same state),
  ``evaluate_checkpoint`` (the epoch's validation, to the bit: the same weights and
  arithmetic) and ``evaluate_from_recipe``. (TensorBoard is off: it would load
  TensorFlow here.)
- ``evaluate_checkpoint`` on the JAX model's weights (carried across by
  ``conversion/from_jax.py``) against the JAX ``Trainer.evaluate`` on the same val set,
  whose targets are the JAX model's own detections moved by a seeded offset: within
  the tolerances of ``tests/test_torch_trainer_validation.py`` (1e-6 on every metric,
  ``rtol=1e-5`` on ``Loss``).
- ``models.get``'s ``load_backbone``, ``strict_load`` and ``checkpoint_num_classes``.
"""

import filecmp
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu.training import dataloaders as jax_loaders
from super_gradients_tpu.training.trainer import Trainer as JaxTrainer
from super_gradients_tpu_torch import evaluate_checkpoint, evaluate_from_recipe, models, train_from_recipe
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.training import Trainer
from super_gradients_tpu_torch.training.metrics import detection as det
from test_torch_detection_transforms import smooth_image
from test_torch_yolo_nas import jax_numpy_variables
from torch_jax_init import jax_model as traced_jax_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE_FILES = ["roboflow_yolo_nas_m.yaml", "coco2017_yolo_nas_s.yaml", "training_hyperparams/default_train_params.yaml",
                "training_hyperparams/coco2017_yolo_nas_train_params.yaml",
                "dataset_params/coco_detection_yolo_nas_dataset_params.yaml",
                "dataset_params/roboflow_detection_dataset_params.yaml", "roboflow_yolo_nas_s.yaml",
                "arch_params/yolo_nas_s_arch_params.yaml", "arch_params/yolo_nas_m_arch_params.yaml",
                "arch_params/yolo_nas_l_arch_params.yaml",
                # the Cityscapes segmentation zoo (DDRNet, RegSeg48, SegFormer, UNet)
                "cityscapes_ddrnet.yaml", "cityscapes_al_ddrnet.yaml", "cityscapes_regseg48.yaml",
                "cityscapes_segformer.yaml", "cityscapes_segformer_b0.yaml", "cityscapes_segformer_b1.yaml",
                "cityscapes_segformer_b2.yaml", "cityscapes_segformer_b3.yaml", "cityscapes_segformer_b4.yaml",
                "cityscapes_segformer_b5.yaml", "arch_params/unet_arch_params.yaml",
                "arch_params/unet_default_arch_params.yaml", "dataset_params/cityscapes_dataset_params.yaml",
                "dataset_params/cityscapes_al_dataset_params.yaml", "dataset_params/cityscapes_ddrnet_dataset_params.yaml",
                "dataset_params/cityscapes_regseg48_dataset_params.yaml",
                "dataset_params/cityscapes_segformer_dataset_params.yaml"]
NUM_CLASSES, SIDE = 4, 64


@pytest.mark.parametrize("name", RECIPE_FILES)
def test_recipe_files_are_byte_equal_copies(name):
    assert filecmp.cmp(os.path.join(REPO, "super_gradients_tpu_torch", "recipes", name),
                       os.path.join(REPO, "super_gradients_tpu", "recipes", name), shallow=False)


@pytest.mark.parametrize("overrides", [[], ["lr=0.003", "batch_size=8", "val_batch_size=4", "num_workers=2", "epochs=3",
                                            "ema=False", "resume=True"],
                                       ["training_hyperparams.max_epochs=7", "dataset_params.train_dataset_params.image_size=[320,320]",
                                        "num_classes=5", "dataset_name=aerial-pool", "extra.key={a: 1, b: [1, 2]}"]])
@pytest.mark.parametrize("name", ["roboflow_yolo_nas_m", "roboflow_yolo_nas_s", "coco2017_yolo_nas_s",
                                  "training_hyperparams/default_train_params.yaml"])
def test_load_recipe_equals_jax(name, overrides):
    assert config.load_recipe(name, overrides=overrides) == jax_config.load_recipe(name, overrides=overrides)


def test_recipes_need_pyyaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    for call in (lambda: config.load_recipe("roboflow_yolo_nas_m"), lambda: config.add_params_to_cfg({}, ["a=1"])):
        with pytest.raises(ImportError, match="PyYAML"):
            call()
    assert config.add_params_to_cfg({"a": {"b": 1}}, ["a.c="]) == {"a": {"b": 1, "c": None}}  # an empty value needs no parser


def _write_split(folder, images, boxes_labels):
    os.makedirs(folder, exist_ok=True)
    entries, anns = [], []
    for i, (image, (boxes, labels)) in enumerate(zip(images, boxes_labels)):
        Image.fromarray(image).save(os.path.join(folder, f"{i}.png"))
        entries.append({"id": i, "file_name": f"{i}.png", "height": SIDE, "width": SIDE})
        for (x1, y1, x2, y2), c in zip(boxes, labels):
            anns.append({"id": len(anns), "image_id": i, "category_id": int(c), "iscrowd": 0,
                         "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)]})
    with open(os.path.join(folder, "_annotations.coco.json"), "w") as f:
        json.dump({"images": entries, "annotations": anns,
                   "categories": [{"id": c, "name": f"c{c}"} for c in range(NUM_CLASSES)]}, f)


@pytest.fixture(scope="module")
def jax_model():
    jm = traced_jax_model("yolo_nas_s", num_classes=NUM_CLASSES, image_size=SIDE)
    v = jax_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    return jm, v


@pytest.fixture(scope="module")
def run(tmp_path_factory, jax_model):
    """One recipe run on the CPU; the val targets are the detections of the JAX model's
    weights (through the port, which holds them to the JAX forward), jittered."""
    _, v = jax_model
    carried = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=SIDE, device="cpu")
    carried.load_state_dict(variables_from_jax_to_torch(v))
    root = str(tmp_path_factory.mktemp("recipe"))
    rng = np.random.RandomState(0)
    train_images = [smooth_image(rng, SIDE, SIDE) for _ in range(8)]
    train_boxes = []
    for _ in range(8):
        xy = rng.uniform(0, 40, (3, 2))
        train_boxes.append((np.concatenate([xy, xy + rng.uniform(8, 24, (3, 2))], 1), rng.randint(0, NUM_CLASSES, 3)))
    _write_split(os.path.join(root, "rf100", "tiny", "train"), train_images, train_boxes)
    valid_images = [smooth_image(rng, SIDE, SIDE) for _ in range(8)]
    x = torch.from_numpy(np.stack(valid_images).transpose(0, 3, 1, 2).astype(np.float32) / 255.0)
    with torch.no_grad():
        nms = det.DetectionMetrics(num_cls=NUM_CLASSES).preprocess_device(carried.net(x), None)
    valid_boxes = []
    for i in range(8):  # the random-init boxes reach past the image: kept as they are
        n = min(int(nms.num_detections[i]), 50)
        valid_boxes.append((nms.boxes[i, :n].numpy() + rng.randn(n, 4) * 2.0, nms.labels[i, :n].numpy()))
    _write_split(os.path.join(root, "rf100", "tiny", "valid"), valid_images, valid_boxes)

    overrides = ["architecture=yolo_nas_s", "device=cpu", f"num_classes={NUM_CLASSES}", "dataset_name=tiny",
                 "experiment_name=recipe_cpu", f"ckpt_root_dir={root}/ckpt", "epochs=1", "batch_size=4",
                 "val_batch_size=4", "num_workers=0", "training_hyperparams.lr_warmup_epochs=0",
                 "training_hyperparams.sg_logger_params.tensorboard=False"]
    for split in ("train", "val"):
        overrides += [f"dataset_params.{split}_dataset_params.data_dir={root}/rf100",
                      f"dataset_params.{split}_dataset_params.image_size=[{SIDE},{SIDE}]"]
    model, trainer = train_from_recipe.main(["--config-name=roboflow_yolo_nas_m", *overrides])
    return root, overrides, model, trainer


def test_train_from_recipe_writes_the_recipe_and_checkpoints(run):
    root, overrides, model, trainer = run
    cfg = config.load_recipe("roboflow_yolo_nas_m", overrides=overrides)
    assert model.device.type == "cpu" and model.name == "yolo_nas_s" and model.num_classes == NUM_CLASSES
    assert len(trainer.train_loss_history) == 1 and np.isfinite(trainer.train_loss_history[0])
    assert trainer.train_state.step == 2  # 8 images in batches of 4, drop_last
    (valid,) = trainer.valid_metrics_history
    assert set(valid) == {"mAP@0.50", "Precision@0.50", "Recall@0.50", "F1@0.50", "Best_score_threshold", "Loss"}
    with open(os.path.join(trainer.ckpt_dir, "recipe.json")) as f:
        assert json.load(f) == cfg
    for name in ("ckpt_latest.pth", "ckpt_best.pth", "average_model.pth"):
        assert os.path.isfile(os.path.join(trainer.ckpt_dir, name))


def test_resume_and_evaluate_a_recipe_run(run):
    root, overrides, _, trainer = run
    _, resumed = Trainer.resume_experiment("recipe_cpu", ckpt_root_dir=f"{root}/ckpt")
    assert resumed.ckpt_dir == trainer.ckpt_dir and resumed.train_loss_history == []
    a, b = trainer.train_state, resumed.train_state
    assert a.step == b.step
    for x, y in ((a.net.state_dict(), b.net.state_dict()), (a.ema.state_dict(), b.ema.state_dict())):
        assert all(torch.equal(x[k], y[k]) for k in x)

    results = evaluate_checkpoint.main(["--experiment_name=recipe_cpu", f"--ckpt_root_dir={root}/ckpt"])
    assert results == trainer.valid_metrics_history[0]  # the EMA weights, eval-mode BN, fp32 on both sides
    from_recipe = evaluate_from_recipe.main(["--config-name=roboflow_yolo_nas_m", *overrides,
                                             f"--checkpoint-path={trainer.ckpt_dir}/ckpt_best.pth"])
    # one batch of 8 here against batches of 4: every metric but the batch-mean Loss is the same
    assert {k: v for k, v in from_recipe.items() if k != "Loss"} == {k: v for k, v in results.items() if k != "Loss"}


def test_evaluate_checkpoint_matches_jax_evaluate(run, jax_model):
    root, overrides, _, trainer = run
    jm, v = jax_model
    sd = variables_from_jax_to_torch(v)
    torch.save({"net": sd, "ema_net": sd, "epoch": 0}, os.path.join(trainer.ckpt_dir, "ckpt_jax.pth"))
    got = Trainer.evaluate_checkpoint("recipe_cpu", ckpt_root_dir=f"{root}/ckpt", ckpt_name="ckpt_jax")
    cfg = config.load_recipe("roboflow_yolo_nas_m", overrides=overrides)
    loader = jax_loaders.get(cfg["val_dataloader"], dataset_params=cfg["dataset_params"]["val_dataset_params"],
                             dataloader_params=cfg["dataset_params"]["val_dataloader_params"])
    ref = JaxTrainer("eval", ckpt_root_dir=f"{root}/jax").evaluate(jm, loader, cfg["training_hyperparams"])
    assert set(got) == set(ref) and 0.05 < got["mAP@0.50"] < 0.95, got
    for k in ref:
        if k == "Loss":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)
        else:
            assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])


def test_recipe_callbacks_and_unported_branches_raise(tmp_path, monkeypatch):
    """Named pre-launch callbacks resolve as in the JAX trainer: the batch-size probe,
    called with the recipe alone, hands it back unchanged as the JAX one does; QAT's raises
    naming its ROADMAP item, an unknown name raises KeyError as the JAX registry does; a
    teacher source on a model without a teacher is ignored; ``pretrained_weights`` with an empty mirror raises
    ``FileNotFoundError`` naming the URL, as the JAX package does (``tests/test_torch_predict.py``
    holds the two to each other)."""
    import super_gradients_tpu.training.pre_launch_callbacks  # noqa: F401  (registers the JAX callbacks)
    from super_gradients_tpu.training.trainer import Trainer as JaxTrainer

    recipe = {"pre_launch_callbacks_list": [{"AutoTrainBatchSizeSelectionCallback": {"max_batch_size": 64}}],
              "dataset_params": {"train_dataloader_params": {"batch_size": 16}}}
    assert Trainer._trigger_cfg_modifying_callbacks(dict(recipe)) == JaxTrainer._trigger_cfg_modifying_callbacks(dict(recipe))
    assert Trainer._trigger_cfg_modifying_callbacks(dict(recipe)) == recipe
    with pytest.raises(KeyError, match="ROADMAP.md queue 1, item 8"):
        Trainer._trigger_cfg_modifying_callbacks({"pre_launch_callbacks_list": [{"QATRecipeModificationCallback": {}}]})
    with pytest.raises(KeyError, match="Unknown"):
        Trainer._trigger_cfg_modifying_callbacks({"pre_launch_callbacks_list": ["NoSuchCallback"]})
    cfg = Trainer._trigger_cfg_modifying_callbacks({"pre_launch_callbacks_list": [lambda c: {**c, "seen": True}]})
    assert cfg["seen"]
    # a teacher source on a model without a teacher is not read, as in the JAX trainer
    ignored = Trainer._model_from_cfg({"architecture": "resnet18_cifar", "device": "cpu",
                                       "checkpoint_params": {"teacher_checkpoint_path": "teacher.pth"}})
    fresh = models.get("resnet18_cifar", device="cpu").net.state_dict()
    assert all(torch.equal(v, fresh[k]) for k, v in ignored.net.state_dict().items())
    monkeypatch.setenv("SG_PRETRAINED_DIR", str(tmp_path))
    url = "https://sg-hub-nv.s3.amazonaws.com/models/yolo_nas_s_coco.pth"
    with pytest.raises(FileNotFoundError, match=url):
        Trainer._model_from_cfg({"architecture": "yolo_nas_s", "device": "cpu",
                                 "checkpoint_params": {"pretrained_weights": "coco"}})


def test_models_get_checkpoint_params(tmp_path):
    kw = dict(num_classes=NUM_CLASSES, image_size=SIDE, device="cpu")
    source = models.get("yolo_nas_s", seed=1, **kw).net.state_dict()
    own = models.get("yolo_nas_s", seed=2, **kw).net.state_dict()
    path = str(tmp_path / "source.pth")
    torch.save({"net": source, "ema_net": None}, path)

    backbone = models.get("yolo_nas_s", seed=2, checkpoint_path=path, load_backbone=True, **kw).net.state_dict()
    assert all(torch.equal(backbone[k], (source if k.startswith("backbone.") else own)[k]) for k in own)

    partial = {k: v for k, v in source.items() if not k.startswith("heads.")}
    torch.save({"net": partial}, path)
    with pytest.raises(RuntimeError):
        models.get("yolo_nas_s", seed=2, checkpoint_path=path, **kw)
    loose = models.get("yolo_nas_s", seed=2, checkpoint_path=path, strict_load=False, **kw).net.state_dict()
    assert all(torch.equal(loose[k], (source if k in partial else own)[k]) for k in own)

    torch.save({"net": source}, path)
    swapped = models.get("yolo_nas_s", seed=2, checkpoint_path=path, checkpoint_num_classes=NUM_CLASSES,
                         **dict(kw, num_classes=3))
    fresh = models.get("yolo_nas_s", seed=2, **dict(kw, num_classes=3)).net.state_dict()
    assert swapped.num_classes == 3
    for k, t in swapped.net.state_dict().items():
        same_shape = source[k].shape == t.shape
        assert torch.equal(t, source[k] if same_shape else fresh[k]), k
    assert any(source[k].shape != t.shape for k, t in swapped.net.state_dict().items())
