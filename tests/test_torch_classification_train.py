"""``Trainer.train`` of ``resnet18_cifar`` in the port against the JAX package's trainer.

``resnet18_cifar`` at its full width, 32x32, B=4: the port model's weights go into the JAX
model, and both trainers take the same two ``RandomClassificationDataset`` batches in the
same order (1 epoch, no shuffle), in fp32: SGD with momentum 0.9 and weight decay 1e-4 off
biases and BN (rank >= 2 only, the JAX mask), a cosine schedule, label-smoothed
cross entropy (0.1), ``Accuracy`` / ``Top5`` as train and validation metrics and
``save_model=False``. As ``test_torch_train_step.py`` holds YOLO-NAS, both fp32 runs are
held to the port's fp64 run of the same steps by the L2 distance over each group of
tensors (weights, BN running means, BN running variances): the port's fp32 run no further
from it than twice the JAX fp32 run plus fp32 resolution, and the JAX run within 10% of
the distance the steps moved. BN running variances are torch's unbiased update and flax's
biased one, mapped by ``c = n / (n - 1)``. The train and validation metrics are equal to
JAX's; the epoch's train loss (whose second batch comes after the first step) is held to
the fp64 run as the weights are, and so is the validation loss, which reads the running
variances in eval mode.

One-hot targets give the int targets' run bit for bit (losses, metrics and weights).
"""

import jax
import numpy as np
import pytest
import torch

from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu.training.trainer import Trainer as JaxTrainer
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import RESNET_RULES, variables_from_jax_to_torch
from super_gradients_tpu_torch.training import RandomClassificationDataset, Trainer
from super_gradients_tpu_torch.training.callbacks import Callback
from test_torch_classification_model import carried_pair

torch.set_num_threads(2)

B, IMAGE, NUM_CLASSES = 4, 32, 10
BN_MOMENTUM = 0.1
PARAMS = dict(
    max_epochs=1, loss="CrossEntropyLoss", criterion_params={"label_smoothing": 0.1},
    optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 1e-4}, zero_weight_decay_on_bias_and_bn=True,
    initial_lr=0.02, lr_mode="CosineLRScheduler", cosine_final_lr_ratio=0.1,
    train_metrics_list=["Accuracy", "Top5"], valid_metrics_list=["Accuracy", "Top5"], metric_to_watch="Accuracy",
    save_model=False, sg_logger_params={"tensorboard": False},
)


def _port_loader(onehot=False):
    ds = RandomClassificationDataset(2 * B, (IMAGE, IMAGE), NUM_CLASSES)
    if onehot:
        ds = [(img, np.eye(NUM_CLASSES, dtype=np.float32)[label]) for img, label in ds]
    return torch.utils.data.DataLoader(ds, batch_size=B, shuffle=False)


def _f64(loader):
    return [(images.double(), targets) for images, targets in loader]


def _port_model(state_dict):
    model = models.get("resnet18_cifar", num_classes=NUM_CLASSES, device="cpu")
    model.load_state_dict(state_dict)
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm, pm = carried_pair("resnet18_cifar", num_classes=NUM_CLASSES)
    sd0 = {k: v.clone() for k, v in pm.net.state_dict().items()}
    loader = jax_dataloaders.DataLoader(
        jax_dataloaders.RandomClassificationDataset(2 * B, (IMAGE, IMAGE), NUM_CLASSES), batch_size=B)
    jt = JaxTrainer("cls_parity", ckpt_root_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt.train(jm, dict(PARAMS, sg_logger_params={}), loader, loader)

    root = str(tmp_path_factory.mktemp("port_ckpt"))
    pt = Trainer("cls_parity", ckpt_root_dir=root)
    pt.train(pm, PARAMS, _port_loader(), _port_loader())
    ref = _port_model(sd0)
    ref.net.double()
    rt = Trainer("cls_parity_fp64", ckpt_root_dir=root)
    rt.train(ref, PARAMS, _f64(_port_loader()), _f64(_port_loader()))
    return dict(sd0=sd0, jax_model=jm, jax_trainer=jt, port_model=pm, port_trainer=pt, ref_model=ref, ref_trainer=rt,
                root=root)


def _bn_inputs_per_channel():
    net = models.get("resnet18_cifar", num_classes=NUM_CLASSES, device="cpu").net.eval()
    sizes = {}
    hooks = [m.register_forward_pre_hook(lambda mod, inp, n=n: sizes.__setitem__(n, inp[0].numel() // inp[0].shape[1]))
             for n, m in net.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        net(torch.zeros(B, 3, IMAGE, IMAGE))
    for h in hooks:
        h.remove()
    return sizes


def _jax_in_torch_terms(jax_vars, v0, steps=2):
    """The JAX state as a torch state_dict, running variances made unbiased."""
    out = variables_from_jax_to_torch(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_vars)), RESNET_RULES)
    gain = (1 - BN_MOMENTUM) ** steps  # the coefficient of v0 when every batch variance is 0
    for key, n in ((k + ".running_var", n) for k, n in _bn_inputs_per_channel().items()):
        c = n / (n - 1)
        out[key] = c * out[key].double() + (1 - c) * gain * v0[key].double()
    return out


GROUPS = {
    "weights": lambda k: not any(k.endswith(s) for s in ("running_mean", "running_var", "num_batches_tracked")),
    "running_mean": lambda k: k.endswith("running_mean"),
    "running_var": lambda k: k.endswith("running_var"),
}


def _distance(a, b, keys):
    return float(sum(((a[k].double() - b[k].double()) ** 2).sum() for k in keys) ** 0.5)


@pytest.mark.parametrize("group", list(GROUPS))
def test_weights_and_bn_buffers_match_jax(runs, group):
    v0 = runs["sd0"]
    jax_t = _jax_in_torch_terms(runs["jax_model"].variables, v0)
    port, ref = runs["port_model"].net.state_dict(), runs["ref_model"].net.state_dict()
    keys = [k for k in ref if GROUPS[group](k)]
    assert set(jax_t) == set(port) == set(ref)
    e_jax, e_port = _distance(jax_t, ref, keys), _distance(port, ref, keys)
    floor = 1e-7 * _distance(ref, {k: torch.zeros(()) for k in keys}, keys)
    moved = _distance(ref, v0, keys)
    assert moved > 100 * floor
    assert e_port <= 2 * e_jax + floor, (e_jax, e_port, floor)
    assert e_jax <= 0.1 * moved + floor, (e_jax, e_port, moved)


def test_losses_and_metrics_match_jax(runs):
    jt, pt, rt = runs["jax_trainer"], runs["port_trainer"], runs["ref_trainer"]
    (jh,), (ph,), (rh,) = jt.train_loss_history, pt.train_loss_history, rt.train_loss_history
    print("train loss JAX fp32 / port fp32 / port fp64:", jh, ph, rh)
    assert abs(ph - rh) <= 2 * abs(jh - rh) + 1e-6 * rh, (jh, ph, rh)
    assert pt.train_metrics_history == jt.train_metrics_history
    (valid,), (jvalid,), (rvalid,) = pt.valid_metrics_history, jt.valid_metrics_history, rt.valid_metrics_history
    assert set(valid) == {"Accuracy", "Top5", "Loss"}
    assert {k: valid[k] for k in ("Accuracy", "Top5")} == {k: jvalid[k] for k in ("Accuracy", "Top5")}
    # eval-mode BN reads the running variances, torch's unbiased and flax's biased ones
    # (1.6% apart at the last stage's n = 64): the loss is held to the port's fp64 run
    print("valid loss JAX fp32 / port fp32 / port fp64:", jvalid["Loss"], valid["Loss"], rvalid["Loss"])
    assert abs(valid["Loss"] - rvalid["Loss"]) <= 2 * abs(jvalid["Loss"] - rvalid["Loss"]) + 1e-6 * rvalid["Loss"]
    assert pt.unconsumed_training_params == []


def test_weight_decay_reaches_conv_and_linear_weights_only(runs):
    """``zero_weight_decay_on_bias_and_bn``: the JAX mask (rank >= 2) on the port's names."""
    opt = runs["port_trainer"].train_state.optimizer
    net = runs["port_trainer"].train_state.net
    names = {id(p): n for n, p in net.named_parameters()}
    decayed = {names[id(p)] for g in opt.param_groups if g["weight_decay"] > 0 for p in g["params"]}
    assert decayed == {n for n, p in net.named_parameters() if p.ndim >= 2}
    assert "linear.weight" in decayed and "linear.bias" not in decayed and "bn1.weight" not in decayed
    assert any(n.endswith("shortcut.0.weight") for n in decayed)


def test_step_lr_schedule_reaches_the_resnet(tmp_path):
    """``StepLRScheduler`` (the CIFAR recipe's) drops the LR at its epochs for this model too."""
    _, pm = carried_pair("resnet18_cifar", num_classes=NUM_CLASSES)
    trainer = Trainer("steplr", ckpt_root_dir=str(tmp_path))
    lrs = []

    class Probe(Callback):
        def on_train_loader_end(self, ctx):
            lrs.append(ctx.lr)

    params = dict(PARAMS, max_epochs=3, lr_mode="StepLRScheduler", lr_updates=[1, 2], lr_decay_factor=0.5,
                  initial_lr=0.01, valid_metrics_list=[])
    trainer.train(pm, params, _port_loader(), additional_callbacks=[Probe()])
    np.testing.assert_allclose(lrs, [0.01, 0.005, 0.0025])


def test_one_hot_targets_train_as_int_targets(tmp_path):
    """One-hot rows go through the step, the train metrics and the eval loop to the same bits."""
    results = []
    for onehot in (False, True):
        _, pm = carried_pair("resnet18_cifar", num_classes=NUM_CLASSES)
        trainer = Trainer(f"onehot_{onehot}", ckpt_root_dir=str(tmp_path))
        trainer.train(pm, PARAMS, _port_loader(onehot), _port_loader(onehot))
        results.append((trainer.train_loss_history, trainer.train_metrics_history, trainer.valid_metrics_history,
                        pm.net.state_dict()))
    (l0, m0, v0, s0), (l1, m1, v1, s1) = results
    assert l0 == l1 and m0 == m1 and v0 == v1
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
