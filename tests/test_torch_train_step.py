"""``Trainer.train`` of the PyTorch port against the JAX package's, end to end.

YOLO-NAS-S, ``num_classes=4``, 64x64, B=4: the JAX model's weights are carried to
the port (``variables_from_jax_to_torch``), and both trainers take the same two
``RandomDetectionDataset`` batches in the same order (1 epoch, no shuffle), in
fp32: SGD with momentum and coupled weight decay (zero on biases and BN), cosine
schedule after a ``LinearBatchLRWarmup``, threshold EMA, ``clip_grad_norm`` and
``save_model=False``. SGD is linear in the gradient, so it carries the small
differences of the two libraries' forwards through unchanged (a first Adam step
moves near-zero gradients by about +-lr whatever their size; Adam is held to
optax on identical gradients in ``test_torch_optim_schedules_ema.py``).

The random-init network is ill-conditioned in fp32 in train mode: rounding grows
through its batch-normalized layers, and the fp32 gradient is a few percent
off the fp64 gradient (``chip_smoke.py`` phase 8 prints it for YOLO-NAS-M).
A large first step then changes the second gradient by far more. So the
steps are small (LR 1e-4 then 1e-3, gradients clipped to norm 1), and both fp32
runs are held to the port's fp64 run of the same two steps, by the L2 distance
over each group (weights, BN running means, BN running variances; live and EMA):
the port's fp32 run no further from it than twice the JAX fp32 run plus fp32
resolution (1e-7 of the group's norm), and the JAX run within 10% of the
distance the two steps moved, plus that resolution. ``train_loss_history``:
``rtol=1e-5`` against JAX.

BN running variances differ by design: torch updates them with the unbiased
batch variance, flax with the biased one. With n = B*H*W inputs per channel of a
BN, the torch value after k steps is ``c * v_jax + (1 - c) * g * v0``, where
``c = n / (n - 1)``, ``v0`` is the initial running variance and ``g * v0`` the value
the same recursion (BN momentum, then EMA) gives when every batch variance is 0:
the JAX buffers are mapped by that relation before the comparison.

bf16 (``torch.autocast``, BN kept fp32) differs from the JAX policy (every
parameter cast to bf16), so one bf16 step is held to the fp32 loss at
``rtol=0.05``, the tolerance of ``tests/test_mixed_precision.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu.training.trainer import Trainer as JaxTrainer
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer
from test_torch_yolo_nas import jax_numpy_variables
from torch_jax_init import jax_model

torch.set_num_threads(2)

B, IMAGE, NUM_CLASSES, MAX_BOXES = 4, 64, 4, 8
BN_MOMENTUM = 0.03  # YOLO-NAS, torch convention
EMA_DECAY = 0.9
PARAMS = dict(
    max_epochs=1, loss="PPYoloELoss", criterion_params={"num_classes": NUM_CLASSES},
    optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 1e-4}, zero_weight_decay_on_bias_and_bn=True,
    initial_lr=1e-3, lr_mode="CosineLRScheduler", cosine_final_lr_ratio=0.1, warmup_mode="LinearBatchLRWarmup",
    lr_warmup_steps=1, warmup_initial_lr=1e-4, ema=True, ema_params={"decay": EMA_DECAY, "decay_type": "threshold"},
    clip_grad_norm=1.0, save_model=False,
)


def _port_loader():
    ds = RandomDetectionDataset(2 * B, (IMAGE, IMAGE), NUM_CLASSES, MAX_BOXES)
    return torch.utils.data.DataLoader(ds, batch_size=B, shuffle=False)


def _port_model(variables):
    model = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE, device="cpu")
    model.net.load_state_dict(variables_from_jax_to_torch(variables), strict=True)
    return model


def _f64(batches):
    return [(images.double(), targets.double()) for images, targets in batches]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm = jax_model("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE)
    v = jax_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    loader = jax_dataloaders.DataLoader(
        jax_dataloaders.RandomDetectionDataset(2 * B, (IMAGE, IMAGE), NUM_CLASSES, MAX_BOXES), batch_size=B)
    jt = JaxTrainer("port_parity", ckpt_root_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt.train(jm, dict(PARAMS, valid_metrics_list=[]), loader)

    pm = _port_model(v)
    x = torch.from_numpy(np.random.RandomState(9).rand(2, IMAGE, IMAGE, 3).astype(np.float32))
    predicted_before = pm.predict_batch_tensor(x)  # builds and caches the deploy-form network
    root = str(tmp_path_factory.mktemp("port_ckpt"))
    pt = Trainer("port_parity", ckpt_root_dir=root)
    pt.train(pm, PARAMS, _port_loader())

    ref = _port_model(v)  # the same run in fp64: the reference both fp32 runs are held to
    ref.net.double()
    rt = Trainer("port_parity_fp64", ckpt_root_dir=root)
    rt.train(ref, PARAMS, _f64(_port_loader()))
    st = jt.train_state
    return dict(
        v0=v, sizes=_bn_inputs_per_channel(), jax_trainer=jt, port_trainer=pt, ref_trainer=rt, port_model=pm, x=x,
        before=predicted_before,
        states={  # (JAX fp32, port fp32, port fp64) weights and buffers
            "ema": (jm.variables, pm.net.state_dict(), ref.net.state_dict()),
            "live": ({"params": st.params, "batch_stats": st.batch_stats}, pt.train_state.net.state_dict(),
                     rt.train_state.net.state_dict()),
        },
    )


def _bn_inputs_per_channel():
    """n = B*H*W of each BN's input in the train forward, by state_dict prefix."""
    net = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE, device="cpu").net.train()
    sizes = {}
    hooks = [m.register_forward_pre_hook(lambda mod, inp, name=name: sizes.__setitem__(name, inp[0].numel() // inp[0].shape[1]))
             for name, m in net.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        net(torch.zeros(B, 3, IMAGE, IMAGE))
    for h in hooks:
        h.remove()
    return sizes


def _zero_variance_gain(steps, ema):
    """The coefficient of v0 in the running variance (or its EMA) when every batch variance is 0."""
    live = avg = 1.0
    for j in range(steps):
        live = (1 - BN_MOMENTUM) * live
        d = min(EMA_DECAY, (1.0 + j) / (10.0 + j))
        avg = d * avg + (1 - d) * live
    return avg if ema else live


def _jax_in_torch_terms(jax_vars, v0, sizes, ema):
    """The JAX state as a torch state_dict, running variances made unbiased (see above)."""
    out = variables_from_jax_to_torch(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_vars)))
    gain = _zero_variance_gain(2, ema)
    for key in [k for k in out if k.endswith("running_var")]:
        n = sizes[key[: -len(".running_var")]]
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


@pytest.mark.parametrize("which", ["ema", "live"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_weights_and_bn_buffers_match_jax(runs, which, group):
    """JAX fp32 and port fp32 against the port's fp64 run (bounds in the module docstring)."""
    v0 = variables_from_jax_to_torch(runs["v0"])
    jax_vars, port, ref = runs["states"][which]
    jax_t = _jax_in_torch_terms(jax_vars, v0, runs["sizes"], ema=which == "ema")
    keys = [k for k in ref if GROUPS[group](k)]
    assert set(jax_t) == set(port) == set(ref)
    e_jax, e_port = _distance(jax_t, ref, keys), _distance(port, ref, keys)
    floor = 1e-7 * _distance(ref, {k: torch.zeros(()) for k in keys}, keys)
    moved = _distance(ref, v0, keys)
    assert e_port <= 2 * e_jax + floor, (e_jax, e_port, floor)
    assert e_jax <= 0.1 * moved + floor, (e_jax, e_port, moved)


def test_train_loss_history_matches_jax(runs):
    jh, ph = runs["jax_trainer"].train_loss_history, runs["port_trainer"].train_loss_history
    (rh,) = runs["ref_trainer"].train_loss_history
    assert len(ph) == 1 and np.isfinite(ph[0])
    e_jax, e_port = abs(jh[0] - rh), abs(ph[0] - rh)
    assert e_port <= 2 * e_jax + 1e-6 * rh, (jh, ph, rh)
    np.testing.assert_allclose(ph, jh, rtol=1e-5)
    assert runs["port_trainer"].unconsumed_training_params == []


def test_running_variance_relation_is_not_vacuous(runs):
    """The smallest BN input (the stride-32 level, 2x2 at 64x64) has n = 16, so the
    unbiased/biased factor is 16/15: 6.7%, far above the tolerance."""
    assert min(runs["sizes"].values()) == B * 2 * 2


def test_predict_after_train_uses_trained_weights(runs):
    pm = runs["port_model"]
    after = pm.predict_batch_tensor(runs["x"])
    fresh = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE, device="cpu")
    fresh.load_state_dict(pm.net.state_dict())
    ref = fresh.predict_batch_tensor(runs["x"])
    for a, r in zip(after, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert not torch.equal(after.scores, runs["before"].scores)
    assert not pm.net.training and runs["port_trainer"].train_state.net.training is False


def test_bf16_step_tracks_fp32_loss(runs, tmp_path):
    """One bf16 step: the loss within rtol=0.05 of the fp32 loss on the same weights
    and batch; parameters, EMA and BN buffers stay fp32."""
    v = runs["v0"]
    images, targets = next(iter(_port_loader()))
    losses = {}
    for mp in (False, True):
        model = _port_model(v)
        trainer = Trainer("bf16", ckpt_root_dir=str(tmp_path))
        trainer.train(model, dict(PARAMS, mixed_precision=mp, max_train_batches=1), [(images, targets)])
        losses[mp] = trainer.train_loss_history[0]
        st = trainer.train_state
        assert {t.dtype for t in st.net.state_dict().values() if t.is_floating_point()} == {torch.float32}
        assert {t.dtype for t in st.ema.tensors} == {torch.float32}
    np.testing.assert_allclose(losses[True], losses[False], rtol=0.05)
