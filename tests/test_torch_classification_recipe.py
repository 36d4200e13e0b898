"""The classification recipes of the port against the JAX package's, on the CPU.

- The recipe files are byte-equal copies, and ``load_recipe`` gives the JAX
  ``load_recipe``'s dict, with the shortcut overrides of JAX's
  ``test_cifar10_recipe_cli_accuracy_floor``.
- End to end at a small size: ``train_from_recipe`` of ``cifar10_resnet``
  (``resnet18_cifar`` at full width, the recipe's SGD, ``StepLRScheduler``,
  ``CrossEntropyLoss``, ``Accuracy`` / ``Top5``) on class-separable CIFAR pickles made as
  that JAX test makes them, cut from 5 x 128 images and 5 epochs to 5 x 32 and 2 epochs.
  ``recipe.json`` is the resolved recipe; ``evaluate_checkpoint`` equals a direct
  ``Trainer.evaluate`` of ``models.get(checkpoint_path=ckpt_best.pth)``; ``evaluate_from_recipe``
  and ``resume_experiment`` run from it. The accuracy floor of 0.90 is held on the card
  (``chip_smoke.py`` phase 14).
- ``imagenet_resnet50``'s loaders (``imagenet_resnet50_train`` / ``_val``, the JAX ImageNet
  loader family) give JAX's batches, and the recipe trains, cut to a narrow ResNet-18.
- ``user_recipe_mnist_example`` feeds 1-channel MNIST into the 3-channel
  ``resnet18_cifar``: it raises in both packages (a JAX fault, ``ROADMAP.md`` section 3).
"""

import filecmp
import json
import os
import struct

import numpy as np
import pytest
import torch

from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu_torch import evaluate_from_recipe, models, train_from_recipe
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.training import Trainer
from test_torch_classification_data import write_image_folder
from tools.cifar10_floor_seeds import write_separable_cifar

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["cifar10_resnet.yaml", "imagenet_resnet50.yaml", "user_recipe_mnist_example.yaml",
         "training_hyperparams/cifar10_resnet_train_params.yaml",
         "training_hyperparams/imagenet_resnet50_train_params.yaml",
         "dataset_params/cifar10_dataset_params.yaml", "dataset_params/cifar100_dataset_params.yaml",
         "dataset_params/imagenet_dataset_params.yaml", "dataset_params/imagenet_resnet50_dataset_params.yaml",
         "arch_params/resnet50_arch_params.yaml", "arch_params/resnet18_cifar_arch_params.yaml"]
SHORTCUTS = ["epochs=5", "lr=0.01", "batch_size=32", "val_batch_size=128", "training_hyperparams.lr_warmup_epochs=0",
             "training_hyperparams.average_best_models=False"]


@pytest.mark.parametrize("name", FILES)
def test_classification_recipe_files_are_byte_equal_copies(name):
    assert filecmp.cmp(os.path.join(REPO, "super_gradients_tpu_torch", "recipes", name),
                       os.path.join(REPO, "super_gradients_tpu", "recipes", name), shallow=False)


@pytest.mark.parametrize("overrides", [[], SHORTCUTS])
@pytest.mark.parametrize("name", ["cifar10_resnet", "imagenet_resnet50", "user_recipe_mnist_example"])
def test_load_classification_recipe_equals_jax(name, overrides):
    got = config.load_recipe(name, overrides=overrides)
    assert got == jax_config.load_recipe(name, overrides=overrides)
    assert got["architecture"] in ("resnet18_cifar", "resnet50")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cifar_recipe"))
    write_separable_cifar(root, 32)
    overrides = ["device=cpu", "experiment_name=cifar_cpu", f"ckpt_root_dir={root}/ckpt", "epochs=2", "lr=0.01",
                 "batch_size=32", "val_batch_size=32", "num_workers=0",
                 f"dataset_params.train_dataset_params.root={root}", f"dataset_params.val_dataset_params.root={root}",
                 "training_hyperparams.lr_warmup_epochs=0", "training_hyperparams.average_best_models=False",
                 "training_hyperparams.sg_logger_params.tensorboard=False"]
    model, trainer = train_from_recipe.main(["--config-name=cifar10_resnet", *overrides])
    return root, overrides, model, trainer


def test_train_from_cifar10_recipe(run):
    root, overrides, model, trainer = run
    cfg = config.load_recipe("cifar10_resnet", overrides=overrides)
    assert model.device.type == "cpu" and model.name == "resnet18_cifar" and type(model).__name__ == "ClassificationModel"
    assert trainer.train_state.step == 2 * 5
    assert len(trainer.train_loss_history) == 2 and all(np.isfinite(trainer.train_loss_history))
    assert trainer.train_loss_history[1] < trainer.train_loss_history[0]
    assert [set(m) for m in trainer.train_metrics_history] == [{"Accuracy", "Top5"}] * 2
    assert all(set(v) == {"Accuracy", "Top5", "Loss"} for v in trainer.valid_metrics_history)
    assert trainer.best_metric == max(v["Accuracy"] for v in trainer.valid_metrics_history)
    with open(os.path.join(trainer.ckpt_dir, "recipe.json")) as f:
        assert json.load(f) == cfg
    for name in ("ckpt_latest.pth", "ckpt_best.pth"):
        assert os.path.isfile(os.path.join(trainer.ckpt_dir, name))


def test_evaluate_checkpoint_from_recipe_and_resume(run):
    root, overrides, _, trainer = run
    cfg = config.load_recipe("cifar10_resnet", overrides=overrides)
    got = Trainer.evaluate_checkpoint("cifar_cpu", ckpt_root_dir=f"{root}/ckpt")
    model = models.get("resnet18_cifar", num_classes=10, device="cpu",
                       checkpoint_path=os.path.join(trainer.ckpt_dir, "ckpt_best.pth"))
    loader = Trainer._loader_from_cfg(cfg, "val")
    direct = Trainer("direct", ckpt_root_dir=f"{root}/direct").evaluate(model, loader, cfg["training_hyperparams"])
    assert set(got) == {"Accuracy", "Top5", "Loss"} and got == direct
    from_recipe = evaluate_from_recipe.main(["--config-name=cifar10_resnet",
                                             f"--checkpoint-path={trainer.ckpt_dir}/ckpt_best.pth", *overrides])
    assert from_recipe == direct
    _, resumed = Trainer.resume_experiment("cifar_cpu", ckpt_root_dir=f"{root}/ckpt")
    assert resumed.ckpt_dir == trainer.ckpt_dir and resumed.train_loss_history == []


@pytest.mark.parametrize("split_dirs", [True, False], ids=["train_val_folders", "one_folder"])
def test_imagenet_resnet50_loaders_match_jax(tmp_path, split_dirs):
    """``imagenet_resnet50.yaml`` names ``imagenet_resnet50_train`` / ``_val``, which the JAX
    package registers too (its ImageNet loader family): the ImageFolder of
    ``data_dir/train`` and ``data_dir/val`` where they exist, else of ``data_dir``, at 224."""
    from super_gradients_tpu.training import dataloaders as jax_dataloaders
    from super_gradients_tpu_torch.training import dataloaders

    root = str(tmp_path)
    for split, seed in (("train", 0), ("val", 1)):
        write_image_folder(os.path.join(root, split) if split_dirs else root, per_class=2, seed=seed)
    for split in ("train", "val"):
        params = {"data_dir": root, "batch_size": 4}
        ref = jax_dataloaders.get(f"imagenet_resnet50_{split}", dataset_params=params)
        got = dataloaders.get(f"imagenet_resnet50_{split}", dataset_params=params)
        pairs = list(zip(got, ref))
        assert len(pairs) == len(ref) > 0
        for (gi, gl), (ri, rl) in pairs:
            assert tuple(gi.shape[1:]) == (3, 224, 224)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(ri).transpose(0, 3, 1, 2))
            np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))


def test_imagenet_resnet50_recipe_trains(tmp_path):
    """The recipe end to end on the CPU (bf16 as the recipe says, cosine after a warmup,
    label smoothing, weight decay off bias and BN), cut to a ResNet-18 at a quarter width,
    3 classes and one epoch of b4 over an ImageFolder written here."""
    root = str(tmp_path)
    for split, seed in (("train", 0), ("val", 1)):
        write_image_folder(os.path.join(root, split), per_class=3, seed=seed)
    overrides = ["device=cpu", f"ckpt_root_dir={root}/ckpt", "architecture=resnet18", "num_classes=3",
                 "arch_params.width_mult=0.25", "epochs=1", "batch_size=4", "val_batch_size=4", "num_workers=0",
                 f"dataset_params.train_dataset_params.data_dir={root}", f"dataset_params.val_dataset_params.data_dir={root}",
                 "training_hyperparams.sg_logger_params.tensorboard=False"]
    model, trainer = train_from_recipe.main(["--config-name=imagenet_resnet50", *overrides])
    assert model.name == "resnet18" and model.net.layer1[0].conv1.out_channels == 16
    assert trainer.train_state.step == 2 and np.isfinite(trainer.train_loss_history[0])
    (valid,) = trainer.valid_metrics_history
    assert set(valid) == {"Accuracy", "Top5", "Loss"}
def test_mnist_recipe_raises_in_both_packages(tmp_path):
    """1-channel MNIST into the 3-channel stem of ``resnet18_cifar``: flax refuses the
    kernel shape, torch the input's channels, at the first step of each."""
    from super_gradients_tpu.train_from_recipe import main as jax_main

    rng = np.random.RandomState(0)
    for prefix, n in (("train", 32), ("t10k", 16)):
        for kind, arr in (("images-idx3", rng.randint(0, 256, (n, 28, 28), dtype=np.uint8)),
                          ("labels-idx1", rng.randint(0, 10, n).astype(np.uint8))):
            payload = bytes([0, 0, 8, arr.ndim]) + b"".join(struct.pack(">I", d) for d in arr.shape) + arr.tobytes()
            (tmp_path / f"{prefix}-{kind}-ubyte").write_bytes(payload)
    overrides = [f"ckpt_root_dir={tmp_path}/ckpt", "epochs=1", "batch_size=16", "val_batch_size=16",
                 f"dataset_params.train_dataset_params.root={tmp_path}",
                 f"dataset_params.val_dataset_params.root={tmp_path}"]
    with pytest.raises(Exception, match=r"\(3, 3, 1, 64\).*\(3, 3, 3, 64\)"):
        jax_main(["--config-name", "user_recipe_mnist_example", *overrides])
    with pytest.raises(RuntimeError, match="expected input.* to have 3 channels, but got 1 channels"):
        train_from_recipe.main(["--config-name=user_recipe_mnist_example", "device=cpu", "num_workers=0",
                                "training_hyperparams.sg_logger_params.tensorboard=False", *overrides])
