"""The Cityscapes recipes of DDRNet, RegSeg48 and SegFormer in the port, on the CPU.

- Each recipe loads to the JAX ``load_recipe``'s dict (the files are byte-equal copies,
  ``tests/test_torch_recipes.py``).
- ``cityscapes_ddrnet``'s loaders over a Cityscapes-layout tree (``tools/cityscapes_synthetic.py``,
  4 + 2 images at 64x128, every trainId and void) at 32x64: the datasets' samples and the
  validation batch equal the JAX loaders' byte for byte, the train loader drops its last batch.
- One step of ``cityscapes_ddrnet``'s criterion (``OhemCELoss``: threshold 0.7, 6.25% mined) on
  the first two train samples through DDRNet-23's layout at ``planes`` 8 with its aux head,
  in fp32 on both sides, JAX weights drawn from a numpy seed: the port's loss and gradients no
  further from the port's fp64 step than twice JAX's fp32 step plus 1e-6 of their scale, and
  the aux head's gradients zero in both (OHEM reads the main map alone, as in JAX).
- ``train_from_recipe`` of ``cityscapes_ddrnet`` (at the narrow DDRNet-23) and of
  ``cityscapes_regseg48`` (RegSeg48's published widths) for one epoch of two b2 steps at 32x64:
  finite losses, ``IoU`` reported.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu.training import losses as jax_losses
from super_gradients_tpu_torch import models, train_from_recipe
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.common.registry import ARCHITECTURES
from super_gradients_tpu_torch.conversion.from_jax import DDRNET_RULES
from super_gradients_tpu_torch.training import dataloaders, losses
from tools.cityscapes_synthetic import write_cityscapes_tree
from torch_seg_parity import load_port, seeded_variables

torch.set_num_threads(2)

RECIPES = ["cityscapes_ddrnet", "cityscapes_al_ddrnet", "cityscapes_regseg48", "cityscapes_segformer",
           "cityscapes_segformer_b0", "cityscapes_segformer_b1", "cityscapes_segformer_b2", "cityscapes_segformer_b3",
           "cityscapes_segformer_b4", "cityscapes_segformer_b5"]
HW = (32, 64)
NARROW = {"planes": 8, "highres_planes": 16, "head_planes": 16, "use_aux_heads": True}


@pytest.mark.parametrize("name", RECIPES)
def test_load_recipe_equals_jax(name):
    got = config.load_recipe(name, overrides=["epochs=2", "batch_size=4"])
    assert got == jax_config.load_recipe(name, overrides=["epochs=2", "batch_size=4"])
    assert got["num_classes"] == 19 and got["architecture"] in ARCHITECTURES


@pytest.fixture(scope="module")
def cityscapes_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes"))
    write_cityscapes_tree(root, train=4, val=2, height=64, width=128, seed=5)
    return root


def _loaders(package, cfg, root):
    get = dataloaders.get if package == "port" else jax_dataloaders.get
    out = []
    for split in ("train", "val"):
        params = dict(cfg["dataset_params"][f"{split}_dataset_params"], root=root, image_size=list(HW), batch_size=2)
        out.append(get(cfg[f"{split}_dataloader"], dataset_params=params))
    return out


@pytest.fixture(scope="module")
def ddrnet_recipe(cityscapes_root):
    cfg = config.load_recipe("cityscapes_ddrnet")
    return cfg, _loaders("port", cfg, cityscapes_root), _loaders("jax", cfg, cityscapes_root)


def test_recipe_loaders_match_jax(ddrnet_recipe):
    """The recipe's train and val datasets give JAX's samples byte for byte; the val loader's
    batch is JAX's; the train loader drops its last partial batch as JAX's does."""
    cfg, (p_train, p_val), (j_train, j_val) = ddrnet_recipe
    assert (cfg["train_dataloader"], cfg["val_dataloader"]) == ("cityscapes_ddrnet_train", "cityscapes_ddrnet_val")
    for p_loader, j_loader in ((p_train, j_train), (p_val, j_val)):
        assert len(p_loader.dataset) == len(j_loader.dataset) > 0
        for i in range(len(p_loader.dataset)):
            (pi, pm), (ji, jm) = p_loader.dataset[i], j_loader.dataset[i]
            np.testing.assert_array_equal(pi.transpose(1, 2, 0), ji)
            np.testing.assert_array_equal(pm, jm)
            assert pi.dtype == ji.dtype == np.float32 and pi.shape[1:] == HW
    (pi, pm), (ji, jm) = next(iter(p_val)), next(iter(j_val))
    np.testing.assert_array_equal(pi.numpy().transpose(0, 2, 3, 1), np.asarray(ji))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert len(p_train) == len(j_train) == 2 and p_train.drop_last


def test_one_step_of_the_recipe_criterion_matches_jax(ddrnet_recipe):
    cfg, (p_train, _), _ = ddrnet_recipe
    tp = cfg["training_hyperparams"]
    samples = [p_train.dataset[i] for i in range(2)]
    x = np.stack([s[0] for s in samples]).transpose(0, 2, 3, 1)
    y = np.stack([s[1] for s in samples]).astype(np.int32)
    spec = jax_models.get_architecture("custom_ddrnet_23")(num_classes=19, arch_params=NARROW, input_hw=HW)
    variables = seeded_variables(spec.module, HW, seed=3)
    jax_loss = jax_losses.get_loss(tp["loss"], tp["criterion_params"])

    def loss_fn(params):
        out, _ = spec.module.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                                   train=True, mutable=["batch_stats"])
        return jax_loss(out, jnp.asarray(y))[0]

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    j_grads = {k: v.double() for k, v in load_port(
        models.get("custom_ddrnet_23", num_classes=19, arch_params=NARROW, input_hw=HW, device="cpu").net,
        {"params": jax.tree_util.tree_map(np.asarray, j_grads), "batch_stats": variables["batch_stats"]},
        DDRNET_RULES).named_parameters()}

    net = load_port(models.get("custom_ddrnet_23", num_classes=19, arch_params=NARROW, input_hw=HW, device="cpu").net,
                    variables, DDRNET_RULES)
    port_loss = losses.get_loss(tp["loss"], tp["criterion_params"])
    results = []
    for model in (net.train(), copy.deepcopy(net).double().train()):
        dtype = next(model.parameters()).dtype
        loss, _ = port_loss(model(torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)), torch.from_numpy(y))
        loss.backward()
        results.append((float(loss.detach()), {k: (torch.zeros_like(p) if p.grad is None else p.grad).double()
                                      for k, p in model.named_parameters()}))
    (p_loss, p_grads), (r_loss, r_grads) = results
    assert abs(p_loss - r_loss) <= 2 * abs(float(j_loss) - r_loss) + 1e-6 * abs(r_loss), (p_loss, float(j_loss), r_loss)

    def dist(grads):
        return float(torch.sqrt(sum(((grads[k] - r_grads[k]) ** 2).sum() for k in r_grads)))

    scale = float(torch.sqrt(sum((g ** 2).sum() for g in r_grads.values())))
    assert scale > 0 and dist(p_grads) <= 2 * dist(j_grads) + 1e-6 * scale, (dist(p_grads), dist(j_grads), scale)
    aux = [k for k in r_grads if k.startswith("seghead_extra.")]
    assert aux and all(float(g.abs().max()) == 0 for grads in (p_grads, j_grads) for k, g in grads.items() if k in aux)


@pytest.mark.parametrize("recipe,extra", [
    ("cityscapes_ddrnet", ["architecture=custom_ddrnet_23"] + [f"arch_params.{k}={v}" for k, v in NARROW.items()]),
    ("cityscapes_regseg48", []),
])
def test_train_from_recipe(recipe, extra, cityscapes_root, tmp_path):
    overrides = ["device=cpu", f"ckpt_root_dir={tmp_path}", "epochs=1", "batch_size=2", "val_batch_size=2",
                 "num_workers=0", f"dataset_params.train_dataset_params.root={cityscapes_root}",
                 f"dataset_params.val_dataset_params.root={cityscapes_root}",
                 f"dataset_params.train_dataset_params.image_size=[{HW[0]},{HW[1]}]",
                 f"dataset_params.val_dataset_params.image_size=[{HW[0]},{HW[1]}]",
                 "training_hyperparams.sg_logger_params.tensorboard=False", *extra]
    model, trainer = train_from_recipe.main([f"--config-name={recipe}", *overrides])
    cfg = config.load_recipe(recipe, overrides=overrides)
    assert model.name == cfg["architecture"] and trainer.train_state.step == 2
    assert len(trainer.train_loss_history) == 1 and np.isfinite(trainer.train_loss_history).all()
    (valid,) = trainer.valid_metrics_history
    assert set(valid) == {"PixelAccuracy", "IoU", "Loss"} and np.isfinite(list(valid.values())).all()
    assert type(trainer.train_state.optimizer).__name__ == "SGD" and trainer.train_state.ema is not None
