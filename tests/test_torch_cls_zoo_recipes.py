"""The classification zoo's loaders and recipes in the PyTorch port against the JAX package's.

- The ten ``imagenet_{efficientnet,regnetY,repvgg,vit_base,vit_large}_{train,val}`` loaders read an
  ImageFolder tree sample for sample as JAX's do.
- The five root recipes and the files they compose are byte-equal copies; ``load_recipe`` resolves
  each as JAX does and the port builds its model, optimizer, loss and metrics.
- The JAX package's departures from the original that the port keeps (ROADMAP.md section 3), pinned
  in both packages.
- ``imagenet_efficientnet`` (RMSProp, EMA, label smoothing) and ``imagenet_vit_base`` (SGD,
  ``clip_grad_norm``) each train one epoch of two steps of b4 through ``train_from_recipe`` on the
  CPU (bf16, as the recipes say), over a seeded ImageFolder tree of 8 train and 4 val PNGs read at
  the recipes' 224x224: the EfficientNet cut to width 0.25 and depth 0.35 (``arch_params``), the
  ViT-Base at patch 32 (49 tokens; ``vit_base`` reads no other width). Losses and metrics finite,
  every parameter changed; ``evaluate_checkpoint.main`` of each run within 1e-6 of a direct
  ``Trainer.evaluate`` of its ``ckpt_best.pth``.
"""

import filecmp
import os

import numpy as np
import pytest
import torch
from PIL import Image

from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu.models.model_factory import get_architecture
from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu_torch import evaluate_checkpoint, models, train_from_recipe
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.common.registry import ARCHITECTURES
from super_gradients_tpu_torch.training import Trainer, dataloaders
from super_gradients_tpu_torch.training.metrics import MetricCollection, get_metric
from test_torch_detection_transforms import smooth_image

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_TOL = 1e-6


def _image_folder(root, per_class=(2, 2)):
    rng = np.random.RandomState(4)
    for split, n in zip(("train", "val"), per_class):
        for c in ("cat", "dog"):
            os.makedirs(os.path.join(root, split, c))
            for i in range(n):
                image = smooth_image(rng, 40 + 8 * i, 48 + 16 * i)
                Image.fromarray(image).save(os.path.join(root, split, c, f"{i}.png"))


LOADERS = [f"imagenet_{f}_{s}" for f in ("efficientnet", "regnetY", "repvgg", "vit_base", "vit_large")
           for s in ("train", "val")]


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagenet"))
    _image_folder(root)
    return root


@pytest.mark.parametrize("name", LOADERS)
def test_imagenet_loaders_read_as_in_jax(name, image_folder):
    """Each sample of the ``data_dir/train`` or ``/val`` ImageFolder at 224x224, the JAX sample with
    its image CHW; the batch size, the shuffle (train only) and ``drop_last`` are JAX's."""
    got = dataloaders.get(name, dataset_params={"data_dir": image_folder}, dataloader_params={"batch_size": 3})
    ref = jax_dataloaders.get(name, dataset_params={"data_dir": image_folder}, dataloader_params={"batch_size": 3})
    assert len(got.dataset) == len(ref.dataset) == 4
    for i in range(4):
        (gx, gy), (rx, ry) = got.dataset[i], ref.dataset[i]
        assert int(gy) == int(ry) and np.asarray(gx).shape == (3, 224, 224)
        np.testing.assert_allclose(np.asarray(gx).transpose(1, 2, 0), np.asarray(rx), atol=1e-6)
    assert (got.batch_size, got.drop_last, got.sampler.shuffle) == (ref.batch_size, ref.drop_last, ref.shuffle)
    assert got.sampler.shuffle == name.endswith("_train")


RECIPES = ["imagenet_efficientnet", "imagenet_regnetY", "imagenet_repvgg", "imagenet_vit_base", "imagenet_vit_large"]
FILES = [f"{r}.yaml" for r in RECIPES] + [
    f"training_hyperparams/imagenet_{n}_train_params.yaml" for n in ("efficientnet", "regnetY", "repvgg", "vit")
] + [f"arch_params/{n}_arch_params.yaml" for n in (
    "efficientnet", *(f"efficientnet_{v}" for v in ("b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7", "b8", "l2")),
    "regnetY", "repvgg", "repvgga0", "repvgga1", "repvgga2", "repvggb0", "repvggb1", "repvggb2", "vit_base")
] + [f"dataset_params/imagenet_{n}_dataset_params.yaml" for n in ("efficientnet", "regnetY", "vit_base")] + [
    f"checkpoint_params/{n}_checkpoint_params.yaml" for n in ("default", "vit_base_imagenet")]


@pytest.mark.parametrize("name", FILES)
def test_recipe_files_are_byte_equal_copies(name):
    assert filecmp.cmp(os.path.join(REPO, "super_gradients_tpu_torch", "recipes", name),
                       os.path.join(REPO, "super_gradients_tpu", "recipes", name), shallow=False)


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_loads_as_in_jax_and_builds(name):
    """The resolved tree equals JAX's; the model (at 8 classes), the optimizer, the loss and the
    validation metrics build in the port."""
    cfg = config.load_recipe(name)
    assert cfg == jax_config.load_recipe(name)
    tp = cfg["training_hyperparams"]
    model = Trainer._model_from_cfg({**cfg, "num_classes": 8, "device": "cpu"})
    assert model.num_classes == 8 and model.name == cfg["architecture"]
    step = Trainer("build").prepare(model, tp, steps_per_epoch=10)
    assert type(step.state.optimizer).__name__ == {"SGD": "SGD", "RMSProp": "RMSProp"}[tp["optimizer"]]
    assert type(step.criterion).__name__ == tp["loss"]
    assert len(MetricCollection([get_metric(m) for m in tp["valid_metrics_list"]]).metrics) == 2


def test_efficientnet_recipe_resolves_to_rmsprop_in_both_packages():
    """``imagenet_efficientnet.yaml`` names ``optimizer:`` twice; PyYAML keeps the last key, so
    both packages train it with RMSProp (the first key says SGD) at the SGD block's
    ``optimizer_params`` (ROADMAP.md section 3)."""
    with open(os.path.join(REPO, "super_gradients_tpu_torch", "recipes", "imagenet_efficientnet.yaml")) as f:
        assert [line.strip() for line in f if line.strip().startswith("optimizer:")] == ["optimizer: SGD",
                                                                                         "optimizer: RMSProp"]
    for load in (config.load_recipe, jax_config.load_recipe):
        tp = load("imagenet_efficientnet")["training_hyperparams"]
        assert tp["optimizer"] == "RMSProp" and tp["optimizer_params"] == {"momentum": 0.9, "weight_decay": 1e-4}


def test_customized_efficientnet_reads_res_not_image_size_in_both_packages():
    ap = {"width_coefficient": 1.0, "depth_coefficient": 1.0, "dropout_rate": 0.2, "image_size": 300, "res": 256}
    assert get_architecture("CustomizedEfficientnet")(arch_params=ap).input_hw == (256, 256)
    assert ARCHITECTURES["CustomizedEfficientnet"](arch_params=ap).input_hw == (256, 256)
    assert get_architecture("efficientnet_b0")(arch_params=ap).input_hw == (300, 300)
    assert ARCHITECTURES["efficientnet_b0"](arch_params=ap).input_hw == (300, 300)


def test_vit_large_ignores_patch_and_image_size_in_both_packages():
    ap = {"image_size": [64, 64], "patch_size": [32, 32]}
    jspec = get_architecture("vit_large")(arch_params=ap)
    with torch.device("meta"):
        spec = ARCHITECTURES["vit_large"](arch_params=ap)
    assert jspec.input_hw == spec.input_hw == (224, 224) and jspec.module.patch_size == 16
    assert spec.net.pos_embedding.shape == (1, 14 * 14 + 1, 1024)
    assert get_architecture("vit_base")(arch_params=ap).input_hw == ARCHITECTURES["vit_base"](arch_params=ap).input_hw


def test_csp_darknet53_is_the_yolox_trunk_in_both_packages():
    """The JAX ``csp_darknet53`` puts its classifier on the YOLOX ``CSPDarknet`` (a 6x6 stride-2
    stem, SiLU, an SPP block before the last CSP layer), not on the original's CSPDarknet-53; the
    port builds the same trunk."""
    from super_gradients_tpu.models.classification.darknet import CSPDarknet53 as JaxCSP

    from super_gradients_tpu_torch.models.detection.yolox import SPPBlock

    assert get_architecture("csp_darknet53")().module.__class__ is JaxCSP
    net = ARCHITECTURES["csp_darknet53"]().net
    assert net._modules_list[0].conv.kernel_size == (6, 6) and isinstance(net._modules_list[0].act, torch.nn.SiLU)
    assert isinstance(net._modules_list[8], SPPBlock)


RECIPE_CUTS = {
    "imagenet_efficientnet": ["arch_params.width_coefficient=0.25", "arch_params.depth_coefficient=0.35"],
    "imagenet_vit_base": ["arch_params.patch_size=[32,32]"],
}


@pytest.fixture(scope="module")
def recipe_runs(tmp_path_factory):
    """Both recipes trained once: {recipe: (cfg, trainer, initial parameters, ckpt root)}."""
    root = str(tmp_path_factory.mktemp("cls_recipes"))
    _image_folder(os.path.join(root, "data"), per_class=(4, 2))
    runs = {}
    for recipe, cut in RECIPE_CUTS.items():
        ckpt_root = os.path.join(root, "ckpt")
        overrides = ["device=cpu", f"ckpt_root_dir={ckpt_root}", "num_classes=2", "epochs=1", "batch_size=4",
                     "val_batch_size=4", "num_workers=0", "training_hyperparams.lr_warmup_epochs=0",
                     "training_hyperparams.average_best_models=False",
                     f"dataset_params.train_dataset_params.data_dir={root}/data",
                     f"dataset_params.val_dataset_params.data_dir={root}/data",
                     "training_hyperparams.sg_logger_params.tensorboard=False", *cut]
        cfg = config.load_recipe(recipe, overrides=overrides)
        initial = {k: v.detach().clone() for k, v in models.get(
            cfg["architecture"], num_classes=2, arch_params=cfg["arch_params"], device="cpu").net.named_parameters()}
        _, trainer = train_from_recipe.main([f"--config-name={recipe}", *overrides])
        runs[recipe] = (cfg, trainer, initial, ckpt_root)
    return runs


@pytest.mark.parametrize("recipe", list(RECIPE_CUTS))
def test_recipe_trains_one_epoch_on_the_cpu(recipe_runs, recipe):
    cfg, trainer, initial, _ = recipe_runs[recipe]
    tp = cfg["training_hyperparams"]
    assert type(trainer.train_state.optimizer).__name__ == {"imagenet_efficientnet": "RMSProp",
                                                            "imagenet_vit_base": "SGD"}[recipe]
    assert (trainer.train_state.ema is not None) == bool(tp["ema"]) and tp.get("clip_grad_norm") == (
        1.0 if recipe == "imagenet_vit_base" else None)
    assert trainer.train_state.step == 2 and len(trainer.train_loss_history) == 1
    assert np.isfinite(trainer.train_loss_history).all()
    live = dict(trainer.train_state.net.named_parameters())
    assert [k for k, v in initial.items() if torch.equal(v, live[k])] == []
    (valid,) = trainer.valid_metrics_history
    assert set(valid) == {"Accuracy", "Top5", "Loss"} and np.isfinite(list(valid.values())).all()


@pytest.mark.parametrize("recipe", list(RECIPE_CUTS))
def test_evaluate_checkpoint_equals_trainer_evaluate(recipe_runs, recipe):
    cfg, trainer, _, ckpt_root = recipe_runs[recipe]
    evaluated = evaluate_checkpoint.main([f"--experiment_name={cfg['experiment_name']}",
                                          f"--ckpt_root_dir={ckpt_root}"])
    model = models.get(cfg["architecture"], num_classes=2, arch_params=cfg["arch_params"], device="cpu",
                       checkpoint_path=os.path.join(trainer.ckpt_dir, "ckpt_best.pth"))
    direct = Trainer("direct", ckpt_root_dir=ckpt_root).evaluate(model, Trainer._loader_from_cfg(cfg, "val"),
                                                                 cfg["training_hyperparams"])
    assert set(evaluated) == set(direct) == {"Accuracy", "Top5", "Loss"}
    for k in direct:
        assert abs(evaluated[k] - direct[k]) <= EVAL_TOL * (abs(direct[k]) if k == "Loss" else 1.0), k
