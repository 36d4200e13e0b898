"""``Trainer.train`` of STDC1-Seg and PP-LiteSeg-T in the port against the JAX package's trainer.

Each model at its published widths (4 classes), 64x128, B=4: the port model's weights go
into the JAX model, and both trainers take the same ``RandomSegmentationDataset`` batches
in the same order (no shuffle), in fp32, in the Cityscapes recipes' regime: SGD with
momentum 0.9 and weight decay 5e-4 off biases and BN (the JAX mask, rank >= 2),
``PolyLRScheduler``, the exp EMA (``beta`` 15), and ``STDCLoss`` (STDC1-Seg: main, two aux
and the detail head; 2 epochs of 2 steps, the first a warmup epoch) or ``DiceCEEdgeLoss``
(PP-LiteSeg-T with its three aux heads; 1 step, no warmup: under this suite's
``--xla_backend_optimization_level=0`` the JAX trainer's PP-LiteSeg weights turn NaN at its
second step, at the default level they do not, and the port's stay finite). B=4: at B=2 the
BNs on 1x1 maps (SPPM's global branch, STDC's context and attention) normalize two values,
and the fp32 gradient of either library lands 0.6-1.7% from fp64, by draw; at B=4 the
port's lands 0.1-0.3% from it and JAX's 1.4-1.7%. The seg heads' dropout is set to 0 on both sides
(the two libraries draw other masks). As ``test_torch_classification_train.py`` holds
ResNet, both fp32 runs are held to the port's fp64 run of the same steps by the L2
distance over each group of tensors (weights, BN running means, BN running variances):
the port's fp32 run no further from it than twice the JAX fp32 run plus fp32 resolution,
and the JAX run within 10% of the distance the steps moved. BN running variances are
torch's unbiased update and flax's biased one, mapped by ``c = n / (n - 1)``. The train
losses and the validation ``Loss``, ``IoU`` and ``PixelAccuracy`` are held to the fp64 run
the same way (the metrics with a floor of 1e-3, some eight of the 32,768 validation pixels:
their argmax flips where two logits are closest, and the runs' weights are fp32 rounding
apart).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu.training.trainer import Trainer as JaxTrainer
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import PPLITESEG_RULES, STDC_RULES, variables_from_jax_to_torch
from super_gradients_tpu_torch.models.segmentation.stdc import SeededDropout
from super_gradients_tpu_torch.training import RandomSegmentationDataset, Trainer
from super_gradients_tpu_torch.training.callbacks import Callback
from torch_jax_init import jax_model

torch.set_num_threads(2)

B, HW, NUM_CLASSES = 4, (64, 128), 4
BN_MOMENTUM = 0.1
PARAMS = dict(
    initial_lr=0.01, lr_mode="PolyLRScheduler",
    optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 5e-4}, zero_weight_decay_on_bias_and_bn=True,
    ema=True, ema_params={"decay": 0.9999, "beta": 15, "decay_type": "exp"}, average_best_models=False,
    valid_metrics_list=[{"PixelAccuracy": {"num_classes": NUM_CLASSES, "ignore_index": 255}},
                        {"IoU": {"num_classes": NUM_CLASSES, "ignore_index": 255}}],
    metric_to_watch="IoU", save_model=False, sg_logger_params={"tensorboard": False},
)
CASES = {  # name: (arch_params, loss, criterion_params, JAX mapper, port rules, epochs, warmup epochs, steps an epoch)
    "stdc1_seg": ({}, "STDCLoss", {"num_classes": NUM_CLASSES}, tc.stdc_key_mapper, STDC_RULES, 2, 1, 2),
    "pp_lite_t_seg": ({"use_aux_heads": True}, "DiceCEEdgeLoss", {"num_classes": NUM_CLASSES, "ignore_index": 255},
                      tc.ppliteseg_key_mapper, PPLITESEG_RULES, 1, 0, 1),
}


def _steps(name):
    return CASES[name][5] * CASES[name][7]


def _params(name):
    _, loss, criterion_params, _, _, epochs, warmup, _ = CASES[name]
    return dict(PARAMS, loss=loss, criterion_params=criterion_params, max_epochs=epochs, lr_warmup_epochs=warmup)


def _port_model(name, state_dict=None):
    model = models.get(name, num_classes=NUM_CLASSES, input_hw=HW, arch_params=CASES[name][0], device="cpu")
    for m in model.net.modules():
        if isinstance(m, SeededDropout):
            m.p = 0.0
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _port_loader(name, f64=False):
    dataset = RandomSegmentationDataset(CASES[name][7] * B, HW, NUM_CLASSES, seed=5)
    batches = list(torch.utils.data.DataLoader(dataset, batch_size=B, shuffle=False))
    return [(images.double(), masks) for images, masks in batches] if f64 else batches


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    name = request.param
    arch_params, _, _, mapper, _, _, _, steps_per_epoch = CASES[name]
    pm = _port_model(name)
    sd0 = {k: v.clone() for k, v in pm.net.state_dict().items()}
    jm = jax_model(name, num_classes=NUM_CLASSES, input_hw=HW, arch_params=arch_params)
    jm.module = type(jm.module)(dataclasses.replace(jm.module.cfg, dropout=0.0))
    sd_np = {k: v.numpy() for k, v in sd0.items()}
    jm.update_variables(jax.tree_util.tree_map(np.asarray, tc.convert_state_dict(sd_np, jm.variables, mapper())))
    loader = jax_dataloaders.DataLoader(
        jax_dataloaders.RandomSegmentationDataset(steps_per_epoch * B, HW, NUM_CLASSES, seed=5), batch_size=B)
    jt = JaxTrainer("seg_parity", ckpt_root_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt.train(jm, dict(_params(name), sg_logger_params={}), loader, loader)

    root = str(tmp_path_factory.mktemp("port_ckpt"))
    lrs = []

    class Probe(Callback):
        def on_train_batch_end(self, ctx):
            lrs.append(ctx.step_metrics["lr"])

    # torch's own CPU convolutions: oneDNN's land further from fp64 than XLA's
    # (tests/test_torch_segmentation_model.py)
    with torch.backends.mkldnn.flags(enabled=False):
        pt = Trainer("seg_parity", ckpt_root_dir=root)
        pt.train(pm, _params(name), _port_loader(name), _port_loader(name), additional_callbacks=[Probe()])
        ref = _port_model(name, sd0)
        ref.net.double()
        rt = Trainer("seg_parity_fp64", ckpt_root_dir=root)
        rt.train(ref, _params(name), _port_loader(name, f64=True), _port_loader(name, f64=True))
    return dict(name=name, sd0=sd0, jax_model=jm, jax_trainer=jt, port_model=pm, port_trainer=pt, ref_model=ref,
                ref_trainer=rt, lrs=lrs)


def _bn_inputs_per_channel(net):
    """Each BN's inputs per channel in a train-mode step (the aux heads' included)."""
    net = net.train()
    sizes = {}
    hooks = [m.register_forward_pre_hook(lambda mod, inp, n=n: sizes.__setitem__(n, inp[0].numel() // inp[0].shape[1]))
             for n, m in net.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        net(torch.zeros(B, 3, *HW))
    for h in hooks:
        h.remove()
    return sizes


def _jax_in_torch_terms(name, jax_vars, v0):
    """The JAX state (the EMA's, which both trainers hand back) as a torch state_dict,
    running variances made unbiased: c * v_jax + (1 - c) * (what v0 contributes)."""
    rules, steps = CASES[name][4], _steps(name)
    out = variables_from_jax_to_torch(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_vars)), rules)
    # the EMA of the running variances mixes the live ones after each step; v0's weight in
    # the result is what the EMA of the live buffer keeps of v0 when every batch variance is 0
    ema = _port_model(name, v0)
    weight_v0 = 0.0
    for s in range(steps):  # the EMA's decay at step s is 0.9999 * (1 - exp(-15 s / steps)): 0 at the first
        decay = 0.9999 * (1 - np.exp(-(s / steps) * 15))
        weight_v0 = decay * weight_v0 + (1 - decay) * (1 - BN_MOMENTUM) ** (s + 1)
    for key, n in ((k + ".running_var", n) for k, n in _bn_inputs_per_channel(ema.net).items()):
        c = n / (n - 1)
        out[key] = c * out[key].double() + (1 - c) * weight_v0 * v0[key].double()
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
    jax_t = _jax_in_torch_terms(runs["name"], runs["jax_model"].variables, v0)
    port, ref = runs["port_model"].net.state_dict(), runs["ref_model"].net.state_dict()
    keys = [k for k in ref if GROUPS[group](k)]
    assert set(jax_t) == set(port) == set(ref)
    e_jax, e_port = _distance(jax_t, ref, keys), _distance(port, ref, keys)
    floor = 1e-7 * _distance(ref, {k: torch.zeros(()) for k in keys}, keys)
    moved = _distance(ref, v0, keys)
    print(f"{runs['name']} {group}: |JAX - fp64| {e_jax:.3e}, |port - fp64| {e_port:.3e}, moved {moved:.3e}")
    assert moved > 100 * floor
    assert e_port <= 2 * e_jax + floor, (e_jax, e_port, floor)
    assert e_jax <= 0.1 * moved + floor, (e_jax, e_port, moved)


def test_losses_and_metrics_match_jax(runs):
    jt, pt, rt = runs["jax_trainer"], runs["port_trainer"], runs["ref_trainer"]
    for jh, ph, rh in zip(jt.train_loss_history, pt.train_loss_history, rt.train_loss_history):
        assert np.isfinite(ph) and abs(ph - rh) <= 2 * abs(jh - rh) + 1e-6 * rh, (jh, ph, rh)
    assert len(pt.train_loss_history) == len(jt.train_loss_history) == CASES[runs["name"]][5]
    for valid, jvalid, rvalid in zip(pt.valid_metrics_history, jt.valid_metrics_history, rt.valid_metrics_history):
        assert set(valid) == set(jvalid) == {"PixelAccuracy", "IoU", "Loss"}
        print(f"{runs['name']} validation JAX / port / port fp64: {jvalid} / {valid} / {rvalid}")
        for k in ("PixelAccuracy", "IoU"):
            assert abs(valid[k] - rvalid[k]) <= 2 * abs(jvalid[k] - rvalid[k]) + 1e-3, (k, jvalid[k], valid[k], rvalid[k])
        assert abs(valid["Loss"] - rvalid["Loss"]) <= 2 * abs(jvalid["Loss"] - rvalid["Loss"]) + 1e-6 * rvalid["Loss"]
    assert pt.unconsumed_training_params == []


def test_poly_schedule_after_warmup_matches_jax(runs):
    """The LR of each step as the JAX trainer's schedule gives it: STDC's warmup epoch (one
    LR an epoch), then the poly decay."""
    from super_gradients_tpu.training.schedules import build_lr_schedule as jax_schedule

    tp = _params(runs["name"])
    sched = jax_schedule(lr_mode="PolyLRScheduler", initial_lr=tp["initial_lr"], max_epochs=tp["max_epochs"],
                         steps_per_epoch=CASES[runs["name"]][7], lr_warmup_epochs=tp["lr_warmup_epochs"])
    lrs = runs["lrs"]
    np.testing.assert_allclose(lrs, [float(sched(s)) for s in range(_steps(runs["name"]))], rtol=1e-6)
    if tp["lr_warmup_epochs"]:
        assert lrs[0] == lrs[1] < tp["initial_lr"] and lrs[1] < lrs[2] and lrs[3] < lrs[2]
    else:
        assert lrs == [tp["initial_lr"]]


def test_weight_decay_reaches_conv_weights_only(runs):
    """``zero_weight_decay_on_bias_and_bn``: the JAX mask (rank >= 2) on the port's names."""
    opt = runs["port_trainer"].train_state.optimizer
    net = runs["port_trainer"].train_state.net
    names = {id(p): n for n, p in net.named_parameters()}
    decayed = {names[id(p)] for g in opt.param_groups if g["weight_decay"] > 0 for p in g["params"]}
    assert decayed == {n for n, p in net.named_parameters() if p.ndim >= 2}
    assert not any(".bn." in n for n in decayed)
