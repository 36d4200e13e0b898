"""Knowledge distillation in the PyTorch port against the JAX package.

- ``KDLogitsLoss`` (T = 2.5, c = 0.3, the task loss given by registry name) and
  ``SegKDLoss`` / ``CWDKlDivLoss`` (port NCHW, JAX NHWC, a tuple output's first map): value,
  aux values and the student gradient in fp64, within 1e-12 relative of ``jax.value_and_grad``
  under ``jax.enable_x64``.
- The ``kd_module`` architecture: ResNet-18 at width 0.25, 10 classes, 64x64, the JAX
  ``KDModule``'s variables (``torch_seg_parity.seeded_variables``) loaded through
  ``conversion/from_jax.py::kd_variables_from_jax_to_torch``; the eval forward's student and
  teacher logits within ``rtol = atol = 1e-4`` (the JAX module under ``jax.jit``).
- ``KDTrainer.train`` of that pair (student and teacher from two seeds) for two SGD steps
  (momentum and weight decay on) with the default ``KDLogitsLoss`` from the training
  parameters: the port in fp64 against JAX's ``KDTrainer`` under ``jax.enable_x64``, the
  hyperparameters exact in float32 (JAX evaluates its LR schedule and optimizer constants in
  float32): the student's weights within 1e-9 of the distance they moved, the train loss within
  1e-10 relative; the teacher bit-unchanged and out of the optimizer.
- The plain ``Trainer`` freezes a ``kd_module``'s teacher (weight decay and EMA on); the recipe
  paths (``train_from_config`` with both keyings, ``_model_from_cfg``, ``train_from_kd_recipe``)
  load the teacher from a port-written ``.pth`` (``teacher_checkpoint_path``) or from a
  temporary ``$SG_PRETRAINED_DIR`` mirror (``teacher_pretrained_weights``).
- The KD recipes are byte-equal copies and load as JAX's; ``imagenet_resnet50_kd.yaml``'s
  ``root:`` raises in both packages (ROADMAP §3).
"""

import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu.models.model_factory import get_architecture as jax_architecture
from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu.training.kd_trainer import KDTrainer as JaxKDTrainer
from super_gradients_tpu.training.losses import kd_losses as jax_kd
from super_gradients_tpu.training.losses import segmentation_losses as jax_seg
from super_gradients_tpu_torch import models, train_from_kd_recipe
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.conversion.from_jax import (
    RESNET_RULES,
    kd_variables_from_jax_to_torch,
    variables_from_jax_to_torch,
)
from super_gradients_tpu_torch.training import RandomClassificationDataset, Trainer, dataloaders
from super_gradients_tpu_torch.training.kd_trainer import KDTrainer
from super_gradients_tpu_torch.training.losses import get_loss
from super_gradients_tpu_torch.training.losses.kd_losses import KDLogitsLoss, KDOutput
from torch_jax_init import jax_model
from torch_seg_parity import numpy_tree, seeded_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC, B, HW = 10, 4, 64
PAIR = {"width_mult": 0.25}
KD_ARCH = {"student": "resnet18", "teacher": "resnet18", "student_arch_params": PAIR, "teacher_arch_params": PAIR}


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert float(np.abs(got - ref).max()) <= rtol * max(float(np.abs(ref).max()), 1e-300)


# ------------------------------------------------------------------ losses

def _kd_logits_case():
    rng = np.random.RandomState(3)
    return rng.randn(6, NC) * 2, rng.randn(6, NC) * 2, rng.randint(0, NC, 6)


def test_kd_logits_loss_value_and_gradient_match_jax_in_fp64():
    s, t, y = _kd_logits_case()
    kw = dict(distillation_loss_coeff=0.3, temperature=2.5)
    with jax.enable_x64():
        ref_loss = jax_kd.KDLogitsLoss("CrossEntropyLoss", **kw)

        def f(s_):
            value, aux = ref_loss(jax_kd.KDOutput(s_, jnp.asarray(t)), jnp.asarray(y))
            return value, aux

        (ref_value, ref_aux), ref_grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(s))
    student = torch.from_numpy(s).requires_grad_()
    loss = get_loss("KDLogitsLoss", dict(task_loss_fn="CrossEntropyLoss", **kw))
    value, aux = loss(KDOutput(student, torch.from_numpy(t)), torch.from_numpy(y))
    value.backward()
    assert isinstance(loss, KDLogitsLoss) and set(aux) == set(ref_aux) == {"task_loss", "distillation_loss"}
    _close(value.item(), float(ref_value), 1e-12)
    for k in aux:
        _close(aux[k].item(), float(ref_aux[k]), 1e-12)
    _close(student.grad.numpy(), np.asarray(ref_grad), 1e-12)
    assert 0 < aux["distillation_loss"].item() and aux["task_loss"].item() != value.item()


@pytest.mark.parametrize("name,tuple_output", [("SegKDLoss", False), ("CWDKlDivLoss", True)])
def test_seg_kd_loss_value_and_gradient_match_jax_in_fp64(name, tuple_output):
    rng = np.random.RandomState(4)
    s, t = rng.randn(2, 3, 5, 6) * 2, rng.randn(2, 3, 5, 6) * 2  # NCHW
    wrap = (lambda a, aux: (a, aux)) if tuple_output else (lambda a, aux: a)
    with jax.enable_x64():
        ref_loss = jax_seg.ChannelWiseKnowledgeDistillationLoss(temperature=3.0)

        def f(s_):
            out = jax_kd.KDOutput(wrap(s_, s_ * 0), wrap(jnp.asarray(t.transpose(0, 2, 3, 1)), 0))
            return ref_loss(out)

        (ref_value, ref_aux), ref_grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(s.transpose(0, 2, 3, 1)))
    student = torch.from_numpy(s).requires_grad_()
    loss = get_loss(name, {"temperature": 3.0})
    value, aux = loss(KDOutput(wrap(student, student * 0), wrap(torch.from_numpy(t), 0)))
    value.backward()
    assert type(loss).__name__ == "ChannelWiseKnowledgeDistillationLoss" and set(aux) == set(ref_aux) == {"cwd_loss"}
    _close(value.item(), float(ref_value), 1e-12)
    _close(student.grad.numpy(), np.asarray(ref_grad).transpose(0, 3, 1, 2), 1e-12)


# ------------------------------------------------------------------ kd_module

@pytest.fixture(scope="module")
def kd_pair():
    spec = jax_architecture("kd_module")(num_classes=NC, arch_params=KD_ARCH)
    variables = seeded_variables(spec.module, (HW, HW), seed=5)
    net = models.get("kd_module", num_classes=NC, arch_params=KD_ARCH, device="cpu").net
    net.load_state_dict(kd_variables_from_jax_to_torch(variables, RESNET_RULES, RESNET_RULES), strict=True)
    return spec.module, variables, net


def test_kd_module_forward_matches_jax(kd_pair):
    module, variables, net = kd_pair
    x = np.random.RandomState(6).randn(2, HW, HW, 3).astype(np.float32)
    ref = jax.jit(functools.partial(module.apply, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert isinstance(got, KDOutput)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(r).max())))
    assert not torch.allclose(got.student_output, got.teacher_output)


def test_kd_module_keeps_the_jax_arch_params_rule(kd_pair):
    """A teacher named as the student takes the student's arch_params in both packages, as the
    JAX zoo resolves them (a ``teacher_arch_params`` of width 0.5 is not read), and ``train()``
    keeps the teacher in eval mode."""
    arch = dict(KD_ARCH, teacher_arch_params={"width_mult": 0.5})
    spec = jax_architecture("kd_module")(num_classes=NC, arch_params=arch)
    assert spec.module.teacher == spec.module.student
    twin = models.get("kd_module", num_classes=NC, arch_params=arch, device="cpu").net
    assert [p.shape for p in twin.teacher.parameters()] == [p.shape for p in twin.student.parameters()]
    net = kd_pair[2]
    net.train()
    assert net.student.training and not net.teacher.training and not any(m.training for m in net.teacher.modules())
    net.eval()


# ------------------------------------------------------------------ KDTrainer against JAX

# constants exact in float32: JAX evaluates the LR schedule and the optimizer's constants in float32
TRAIN_PARAMS = dict(max_epochs=1, optimizer="SGD", optimizer_params={"momentum": 0.875, "weight_decay": 2.0 ** -13},
                    initial_lr=0.0625, task_loss="CrossEntropyLoss", distillation_loss_coeff=0.3, temperature=2.0,
                    valid_metrics_list=["Accuracy"], save_model=False)


def _f64_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def kd_runs(tmp_path_factory):
    variables = [_f64_tree(numpy_tree(jax_model("resnet18", num_classes=NC, arch_params=PAIR, seed=s).variables))
                 for s in (1, 2)]
    with jax.enable_x64():
        js, jt = (jax_model("resnet18", num_classes=NC, arch_params=PAIR, variables=v) for v in variables)
        loader = jax_dataloaders.DataLoader(jax_dataloaders.RandomClassificationDataset(2 * B, (HW, HW), NC), batch_size=B)
        jtrainer = JaxKDTrainer("kd_parity", ckpt_root_dir=str(tmp_path_factory.mktemp("jax_kd")))
        jtrainer.train(training_params=dict(TRAIN_PARAMS, sg_logger_params={}), train_loader=loader, valid_loader=loader,
                       student=js, teacher=jt)
        jax_student = numpy_tree(js.variables)

    ps, pt = (models.get("resnet18", num_classes=NC, arch_params=PAIR, device="cpu") for _ in range(2))
    for model, v in zip((ps, pt), variables):
        model.load_state_dict(variables_from_jax_to_torch(v, RESNET_RULES))
        model.net.double()
    start = {k: v.clone() for k, v in ps.net.state_dict().items()}
    teacher0 = {k: v.clone() for k, v in pt.net.state_dict().items()}
    batches = [(x.double(), y) for x, y in torch.utils.data.DataLoader(RandomClassificationDataset(2 * B, (HW, HW), NC),
                                                                       batch_size=B)]
    trainer = KDTrainer("kd_parity", ckpt_root_dir=str(tmp_path_factory.mktemp("port_kd")))
    returned = trainer.train(training_params=dict(TRAIN_PARAMS, sg_logger_params={"tensorboard": False}),
                             train_loader=batches, valid_loader=batches, student=ps, teacher=pt)
    return dict(jax_trainer=jtrainer, jax_student=variables_from_jax_to_torch(jax_student, RESNET_RULES), trainer=trainer,
                student=ps, returned=returned, start=start, teacher=pt, teacher0=teacher0)


def _weights(sd):
    return [k for k in sd if not k.endswith(("running_var", "num_batches_tracked"))]


def test_kd_trainer_student_matches_jax_in_fp64(kd_runs):
    got, ref, start = kd_runs["student"].net.state_dict(), kd_runs["jax_student"], kd_runs["start"]
    assert kd_runs["returned"] is kd_runs["student"]
    keys = _weights(got)

    def dist(a, b):
        return float(sum(((a[k].double() - b[k].double()) ** 2).sum() for k in keys) ** 0.5)

    moved = dist(got, start)
    assert moved > 1.0
    assert dist(got, ref) <= 1e-9 * moved, (dist(got, ref), moved)


def test_kd_trainer_losses_and_metrics_match_jax(kd_runs):
    port, jax_t = kd_runs["trainer"], kd_runs["jax_trainer"]
    _close(port.train_loss_history, jax_t.train_loss_history, 1e-10)
    assert [v["Accuracy"] for v in port.valid_metrics_history] == [v["Accuracy"] for v in jax_t.valid_metrics_history]
    assert port.unconsumed_training_params == []


def test_kd_trainer_teacher_frozen_and_undecayed(kd_runs):
    net = kd_runs["trainer"].train_state.net
    trained = net.teacher.state_dict()
    assert all(torch.equal(trained[k], v) for k, v in kd_runs["teacher0"].items())
    assert all(torch.equal(kd_runs["teacher"].net.state_dict()[k], v) for k, v in kd_runs["teacher0"].items())
    optimized = {id(p) for g in kd_runs["trainer"].train_state.optimizer.param_groups for p in g["params"]}
    assert not any(id(p) in optimized for p in net.teacher.parameters())
    assert all(id(p) in optimized for p in net.student.parameters())


# ------------------------------------------------------------------ the plain Trainer and the recipe paths

def _kd_model(seed=0):
    return models.get("kd_module", num_classes=NC, arch_params=KD_ARCH, device="cpu", seed=seed)


def _loader(n=2 * B):
    return torch.utils.data.DataLoader(RandomClassificationDataset(n, (HW, HW), NC), batch_size=B)


def test_channels_last_only_for_bf16_training_on_a_gpu():
    from super_gradients_tpu_torch.training.trainer import channels_last_training

    assert channels_last_training(torch.device("cuda"), True)
    assert not channels_last_training(torch.device("cuda"), False)
    assert not channels_last_training(torch.device("cpu"), True)


def test_plain_trainer_freezes_the_kd_module_teacher(tmp_path):
    model = _kd_model()
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    trainer = Trainer("kd_plain", ckpt_root_dir=str(tmp_path))
    trainer.train(model, dict(max_epochs=1, initial_lr=0.05, loss="KDLogitsLoss", ema=True, ema_params={"decay": 0.9},
                              optimizer_params={"momentum": 0.9, "weight_decay": 1e-2}, valid_metrics_list=["Accuracy"],
                              sg_logger_params={"tensorboard": False}, save_model=False), _loader(), _loader())
    after = model.net.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if k.startswith("teacher."))
    assert not all(torch.equal(after[k], v) for k, v in before.items() if k.startswith("student.") and v.is_floating_point())
    assert set(trainer.valid_metrics_history[0]) == {"Accuracy", "Loss"}


def _write_tree(root, n=4):
    rng = np.random.RandomState(7)
    for split in ("train", "val"):
        for c in range(2):
            os.makedirs(os.path.join(root, split, f"c{c}"))
            for i in range(n):
                Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                    os.path.join(root, split, f"c{c}", f"{i}.png"))
    return root


def _teacher_file(tmp_path, name="resnet18_imagenet.pth"):
    teacher = models.get("resnet18", num_classes=NC, arch_params=PAIR, device="cpu", seed=3)
    path = str(tmp_path / name)
    torch.save({"net": teacher.net.state_dict()}, path)
    return path, teacher.net.state_dict()


@pytest.mark.parametrize("source", ["teacher_checkpoint_path", "teacher_pretrained_weights"])
def test_model_from_cfg_loads_the_kd_teacher(tmp_path, monkeypatch, source):
    path, weights = _teacher_file(tmp_path)
    monkeypatch.setenv("SG_PRETRAINED_DIR", str(tmp_path))
    value = path if source == "teacher_checkpoint_path" else "imagenet"
    model = Trainer._model_from_cfg({"architecture": "kd_module", "num_classes": NC, "device": "cpu",
                                     "arch_params": KD_ARCH, "checkpoint_params": {source: value}})
    sd = model.net.state_dict()
    assert all(torch.equal(sd[f"teacher.{k}"], v) for k, v in weights.items())
    fresh = _kd_model().net.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in fresh.items() if k.startswith("student."))


KEYINGS = {
    "kd_module": lambda path: {"arch_params": {"student": "resnet18", "teacher": "resnet18", "student_arch_params": PAIR,
                                               "teacher_arch_params": PAIR},
                               "checkpoint_params": {"teacher_pretrained_weights": "imagenet"}},
    "reference": lambda path: {"student_architecture": "resnet18", "teacher_architecture": "resnet18",
                               "student_arch_params": PAIR, "teacher_arch_params": PAIR,
                               "teacher_checkpoint_params": {"checkpoint_path": path}},
}


@pytest.mark.parametrize("keying", list(KEYINGS))
def test_train_from_config_reads_both_keyings(tmp_path, monkeypatch, keying):
    path, weights = _teacher_file(tmp_path)
    monkeypatch.setenv("SG_PRETRAINED_DIR", str(tmp_path))
    params = {"image_size": (HW, HW), "num_classes": NC, "dataset_size": 2 * B, "batch_size": B}
    cfg = dict(KEYINGS[keying](path), experiment_name=f"kd_{keying}", ckpt_root_dir=str(tmp_path / "ckpt"), num_classes=NC,
               device="cpu", train_dataloader="classification_test_dataloader",
               val_dataloader="classification_test_dataloader",
               dataset_params={"train_dataset_params": params, "val_dataset_params": params},
               training_hyperparams={"max_epochs": 1, "initial_lr": 0.05, "save_model": False,
                                     "sg_logger_params": {"tensorboard": False}})
    student, trainer = KDTrainer.train_from_config(cfg)
    teacher = trainer.train_state.net.teacher.state_dict()
    assert all(torch.equal(teacher[k], v) for k, v in weights.items())
    assert trainer.valid_metrics_history and "Accuracy" in trainer.valid_metrics_history[0]
    fresh = models.get("resnet18", num_classes=NC, arch_params=PAIR, device="cpu").net.state_dict()
    assert not torch.equal(student.net.state_dict()["linear.weight"], fresh["linear.weight"])
    with pytest.raises(ValueError, match="random teacher"):
        KDTrainer.train_from_config({k: v for k, v in cfg.items() if "checkpoint_params" not in k})


def test_train_from_kd_recipe_cli_with_overrides(tmp_path):
    """``imagenet_resnet50_kd`` by overrides on the CPU: a cut pair, the ImageFolder tree given as
    ``data_dir`` (the recipe's ``root:`` is not read), the teacher from a ``.pth``, one epoch; then
    ``evaluate_checkpoint`` of the run equals a direct ``Trainer.evaluate`` of its best checkpoint."""
    root = _write_tree(str(tmp_path / "imagenet"))
    path, weights = _teacher_file(tmp_path, "teacher.pth")
    ckpt = str(tmp_path / "ckpt")
    overrides = ["device=cpu", f"num_classes={NC}", "arch_params.student=resnet18", "arch_params.teacher=resnet18",
                 "arch_params.student_arch_params.width_mult=0.25", "arch_params.teacher_arch_params.width_mult=0.25",
                 "checkpoint_params.teacher_pretrained_weights=null",
                 f"checkpoint_params.teacher_checkpoint_path={path}", f"ckpt_root_dir={ckpt}", "epochs=1",
                 "training_hyperparams.lr_warmup_epochs=0", "training_hyperparams.sg_logger_params.tensorboard=False"]
    for split in ("train", "val"):
        overrides += [f"dataset_params.{split}_dataset_params.{k}={v}" for k, v in
                      (("data_dir", os.path.join(root, split)), ("batch_size", 4), ("image_size", [HW, HW]))]
    student, trainer = train_from_kd_recipe.main(["--config-name=imagenet_resnet50_kd", *overrides])
    assert all(torch.equal(trainer.train_state.net.teacher.state_dict()[k], v) for k, v in weights.items())
    assert np.isfinite(trainer.train_loss_history).all() and len(trainer.valid_metrics_history) == 1
    got = Trainer.evaluate_checkpoint("imagenet_resnet50_kd", ckpt_root_dir=ckpt)
    model = models.get("kd_module", num_classes=NC, device="cpu", arch_params={"student": "resnet18", "teacher": "resnet18",
                                                                              "student_arch_params": PAIR},
                       checkpoint_path=os.path.join(trainer.ckpt_dir, "ckpt_best.pth"))
    cfg = config.load_recipe("imagenet_resnet50_kd", overrides=overrides)
    ref = Trainer("direct", ckpt_root_dir=ckpt).evaluate(model, Trainer._loader_from_cfg(cfg, "val"),
                                                         cfg["training_hyperparams"])
    assert got.keys() == ref.keys() and all(abs(got[k] - ref[k]) <= 1e-6 for k in ref)


# ------------------------------------------------------------------ recipes

RECIPE_FILES = ["imagenet_resnet50_kd.yaml", "cityscapes_kd_base.yaml",
                "dataset_params/imagenet_resnet50_kd_dataset_params.yaml",
                "training_hyperparams/imagenet_resnet50_kd_train_params.yaml",
                "conversion_params/default_conversion_params.yaml", "conversion_params/cifar10_conversion_params.yaml"]


@pytest.mark.parametrize("name", RECIPE_FILES)
def test_recipes_are_byte_equal_and_load_as_jax(name):
    assert filecmp.cmp(os.path.join(REPO, "super_gradients_tpu", "recipes", name),
                       os.path.join(REPO, "super_gradients_tpu_torch", "recipes", name), shallow=False)
    if "/" not in name:
        assert config.load_recipe(name[:-5]) == jax_config.load_recipe(name[:-5])


@pytest.mark.parametrize("split", ["train", "val"])
def test_imagenet_kd_recipe_root_raises_in_both_packages(split):
    """``imagenet_resnet50_kd.yaml`` passes ``root:`` to ``imagenet_train`` / ``_val``, which take
    ``data_dir`` (a JAX-package departure the port keeps, ROADMAP §3): both raise ``TypeError``."""
    cfg = config.load_recipe("imagenet_resnet50_kd")
    assert cfg["dataset_params"][f"{split}_dataset_params"]["root"].startswith("/data/imagenet")
    for get in (dataloaders.get, jax_dataloaders.get):
        with pytest.raises(TypeError, match="data_dir"):
            get(cfg[f"{split}_dataloader"], dataset_params=cfg["dataset_params"][f"{split}_dataset_params"])
