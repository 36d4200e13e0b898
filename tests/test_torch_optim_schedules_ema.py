"""Optimizers, LR schedules, gradient clipping, accumulation and EMA of the port
against the JAX package, on identical gradients.

A tiny network (conv-shaped, linear-shaped and 1-D tensors under ``backbone`` and
``heads``) is given the same numpy-made gradients for 5 micro-steps on both sides:
the port through ``Trainer.prepare(...).update()``, the JAX package through the
transform its trainer builds (``build_optimizer`` with the zero-weight-decay mask
and LR groups, ``clip_by_global_norm`` before it, the frozen-parameter masks,
``MultiSteps`` around it, and ``ema_update`` with the decay of the step before). Parameters and EMA after the
last step: ``atol=1e-6, rtol=1e-5`` (fp32; optax and torch.optim round the same
formulas in other orders). Schedules and EMA decays: ``rtol=1e-6``, schedules
also ``atol=1e-8`` (1e-7 of the initial LR: the JAX package evaluates them in
fp32, the port in Python floats, and the cosine's ``1 + cos`` cancels near the end).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from super_gradients_tpu.training import ema as jax_ema
from super_gradients_tpu.training import optimizers as jax_optimizers
from super_gradients_tpu.training import schedules as jax_schedules
from super_gradients_tpu_torch.training import callbacks, ema, schedules, trainer
from super_gradients_tpu_torch.training.optimizers import Lion, RMSProp, build_optimizer

torch.set_num_threads(2)

SHAPES = {
    "backbone": {"conv_weight": (4, 3, 3, 3), "bn_weight": (4,), "bn_bias": (4,)},
    "heads": {"linear_weight": (5, 4), "linear_bias": (5,), "alpha": (1,)},
}
GRAD_SCALES = (0.05, 3.0, 0.1, 6.0, 0.5)  # global norms below and above the clip threshold


class Tiny(nn.Module):
    def __init__(self, values):
        super().__init__()
        for group, leaves in values.items():
            sub = nn.Module()
            for name, v in leaves.items():
                sub.register_parameter(name, nn.Parameter(torch.from_numpy(v.copy())))
            setattr(self, group, sub)


def _values(seed):
    rng = np.random.RandomState(seed)
    return {g: {n: rng.randn(*s).astype(np.float32) for n, s in leaves.items()} for g, leaves in SHAPES.items()}


def _grads(seed):
    rng = np.random.RandomState(seed + 100)
    return [{g: {n: (rng.randn(*s) * scale).astype(np.float32) for n, s in leaves.items()}
             for g, leaves in SHAPES.items()} for scale in GRAD_SCALES]


CASES = {
    "sgd_nesterov_coupled_wd_groups_clip": dict(
        optimizer="SGD", optimizer_params={"momentum": 0.9, "nesterov": True, "weight_decay": 1e-2},
        zero_weight_decay_on_bias_and_bn=True, initial_lr={"default": 0.1, "heads": 0.03}, clip_grad_norm=2.0,
        lr_mode="CosineLRScheduler", warmup_mode="LinearBatchLRWarmup", lr_warmup_steps=2, warmup_initial_lr=1e-3,
        ema=True, ema_params={"decay": 0.9, "decay_type": "threshold"}),
    "sgd_plain_decay_on_all": dict(
        optimizer="SGD", optimizer_params={"momentum": 0.0, "weight_decay": 1e-3}, initial_lr=0.05,
        ema=True, ema_params={"decay": 0.8, "decay_type": "constant"}),
    "adam": dict(optimizer="Adam", initial_lr=1e-2, lr_mode="PolyLRScheduler",
                 ema=True, ema_params={"decay": 0.99, "decay_type": "exp", "beta": 4}),
    "adam_with_decay_is_adamw": dict(optimizer="Adam", optimizer_params={"weight_decay": 0.1, "b2": 0.99},
                                     initial_lr=1e-2, zero_weight_decay_on_bias_and_bn=True),
    "adamw_groups_clip": dict(
        optimizer="AdamW", optimizer_params={"weight_decay": 0.05, "eps": 1e-6}, zero_weight_decay_on_bias_and_bn=True,
        initial_lr={"default": 2e-2, "backbone": 1e-2}, clip_grad_norm=1.0, lr_mode="CosineLRScheduler",
        cosine_final_lr_ratio=0.1, ema=True, ema_params={"decay": 0.9997, "decay_type": "threshold"}),
    "sgd_frozen_heads_clip": dict(
        optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 1e-2}, initial_lr=0.1, clip_grad_norm=2.0,
        frozen_param_patterns=["heads"], ema=True, ema_params={"decay": 0.9, "decay_type": "threshold"}),
    "sgd_accumulate_2": dict(
        optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 1e-2}, initial_lr=0.1,
        batch_accumulate=2, clip_grad_norm=2.0, lr_mode="StepLRScheduler", lr_updates=[1],
        ema=True, ema_params={"decay": 0.9, "decay_type": "threshold"}),
}
STEPS_PER_EPOCH = 2


def _port_run(case):
    tp = dict(CASES[case], max_epochs=3, loss=lambda out, targets: None)
    model = types.SimpleNamespace(net=Tiny(_values(0)), device=torch.device("cpu"))
    step = trainer.Trainer("t").prepare(model, tp, STEPS_PER_EPOCH)
    params = dict(step.state.net.named_parameters())
    for grads in _grads(0):
        for g, leaves in grads.items():
            for n, v in leaves.items():
                p = params[f"{g}.{n}"]
                p.grad = torch.from_numpy(v.copy()) if p.grad is None else p.grad + torch.from_numpy(v)
        step.update()
    live = {k: v.detach().numpy() for k, v in step.state.net.state_dict().items()}
    averaged = step.state.ema.state_dict() if step.state.ema else None
    return live, averaged and {k: v.numpy() for k, v in averaged.items()}


def _jax_run(case):
    """The JAX trainer's transform chain (trainer.py:144-210, 326-339) on the same gradients."""
    tp = dict(CASES[case])
    k = tp.get("batch_accumulate", 1)
    initial_lr, groups = tp["initial_lr"], None
    if isinstance(initial_lr, dict):
        groups, initial_lr = initial_lr, initial_lr["default"]
    schedule = jax_schedules.build_lr_schedule(
        lr_mode=tp.get("lr_mode"), initial_lr=initial_lr, max_epochs=3, steps_per_epoch=STEPS_PER_EPOCH // k,
        lr_warmup_steps=tp.get("lr_warmup_steps", 0), warmup_initial_lr=tp.get("warmup_initial_lr"),
        warmup_mode=tp.get("warmup_mode", "LinearEpochLRWarmup"),
        cosine_final_lr_ratio=tp.get("cosine_final_lr_ratio", 0.01), lr_updates=tp.get("lr_updates", []))
    params = jax.tree_util.tree_map(jnp.asarray, _values(0))
    tx = jax_optimizers.build_optimizer(tp["optimizer"], params, schedule, tp.get("optimizer_params"),
                                        bool(tp.get("zero_weight_decay_on_bias_and_bn")), groups)
    if tp.get("clip_grad_norm"):
        tx = optax.chain(optax.clip_by_global_norm(tp["clip_grad_norm"]), tx)
    frozen = tp.get("frozen_param_patterns")
    if frozen:
        def trainable(tree, invert=False):
            def leaf(path, _):
                is_frozen = any(pattern in "/".join(k.key for k in path) for pattern in frozen)
                return is_frozen if invert else not is_frozen
            return jax.tree_util.tree_map_with_path(leaf, tree)

        tx = optax.chain(optax.masked(tx, trainable), optax.masked(optax.set_to_zero(), lambda t: trainable(t, True)))
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    opt_state = tx.init(params)
    ema_p = params
    decay_fn = None
    if tp.get("ema"):
        e = tp["ema_params"]
        decay_fn = jax_ema.make_decay_fn(e["decay"], e["decay_type"], e.get("beta", 15), total_steps=3 * STEPS_PER_EPOCH // k)
    for i, grads in enumerate(_grads(0)):
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        if decay_fn and (i + 1) % k == 0:
            ema_p = jax_ema.ema_update(ema_p, params, decay_fn(jnp.float32(i // k)))
    flat = lambda tree: {f"{g}.{n}": np.asarray(v) for g, leaves in tree.items() for n, v in leaves.items()}  # noqa: E731
    return flat(params), flat(ema_p) if decay_fn else None


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_optax(case):
    live, averaged = _port_run(case)
    ref_live, ref_avg = _jax_run(case)
    initial = {f"{g}.{n}": v for g, leaves in _values(0).items() for n, v in leaves.items()}
    frozen = CASES[case].get("frozen_param_patterns", [])
    for name, ref in ref_live.items():
        assert np.array_equal(live[name], initial[name]) == any(p in name for p in frozen), name
        np.testing.assert_allclose(live[name], ref, atol=1e-6, rtol=1e-5, err_msg=name)
    assert (averaged is None) == (ref_avg is None)
    for name, ref in (ref_avg or {}).items():
        np.testing.assert_allclose(averaged[name], ref, atol=1e-6, rtol=1e-5, err_msg=f"EMA {name}")


def test_clip_cases_cover_both_sides_of_the_threshold():
    norms = [np.sqrt(sum((v.astype(np.float64) ** 2).sum() for leaves in g.values() for v in leaves.values()))
             for g in _grads(0)]
    assert min(norms) < 1.0 and max(norms) > 2.0 * 2


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.RandomState(5)
    grads = [(rng.randn(*s) * scale).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    trainer._clip_by_global_norm_(got, 1.0)
    for g, r, orig in zip(got, ref, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)
        assert np.array_equal(g.numpy(), orig) == (scale < 1)


SCHEDULES = {
    "cosine_batch_warmup": dict(lr_mode="CosineLRScheduler", lr_warmup_steps=7, warmup_mode="LinearBatchLRWarmup",
                                warmup_initial_lr=1e-6, cosine_final_lr_ratio=0.1),
    "cosine_epoch_warmup_default_start": dict(lr_mode="cosine", lr_warmup_epochs=2),
    "cosine_epoch_warmup_cooldown": dict(lr_mode="CosineLRScheduler", lr_warmup_epochs=1, warmup_initial_lr=0.01,
                                         lr_cooldown_epochs=2),
    "step_updates": dict(lr_mode="StepLRScheduler", lr_updates=[3, 6], lr_decay_factor=0.5),
    "step_update_freq": dict(lr_mode="step", step_lr_update_freq=2.5, lr_warmup_epochs=1, warmup_initial_lr=0.02),
    "poly_cooldown": dict(lr_mode="PolyLRScheduler", power=0.9, lr_cooldown_epochs=1),
    "exponential": dict(lr_mode="ExponentialLRScheduler", lr_decay_factor=0.8),
    "function": dict(lr_mode="FunctionLRScheduler", lr_schedule_function=lambda lr, e, n: lr * (n - e) / n),
    "constant": dict(lr_mode=None),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    kw = dict(initial_lr=0.1, max_epochs=10, steps_per_epoch=4, **SCHEDULES[name])
    ref, got = jax_schedules.build_lr_schedule(**kw), schedules.build_lr_schedule(**kw)
    for step in range(45):
        np.testing.assert_allclose(got(step), float(ref(jnp.float32(step))), rtol=1e-6, atol=1e-8, err_msg=str(step))


@pytest.mark.parametrize("decay_type", ["constant", "threshold", "exp"])
def test_ema_decay_matches_jax(decay_type):
    ref = jax_ema.make_decay_fn(0.9997, decay_type, beta=15, total_steps=40)
    got = ema.make_decay_fn(0.9997, decay_type, beta=15, total_steps=40)
    for step in (0, 1, 2, 10, 39, 40, 1000):
        np.testing.assert_allclose(got(step), float(ref(jnp.float32(step))), rtol=1e-6)


def test_ema_keeps_tensors_that_never_change():
    """Frozen parameters and the buffers of modules held in eval mode (a KD teacher) are not
    averaged: they stay bit for bit whatever the decay."""
    net = nn.Sequential(nn.Conv2d(2, 3, 1), nn.BatchNorm2d(3), nn.Conv2d(3, 3, 1), nn.BatchNorm2d(3))
    net[0].weight.requires_grad_(False)
    net[3].eval()
    shadow = ema.ModelEMA(net)
    assert "0.weight" not in shadow.names and "3.running_mean" not in shadow.names
    assert {"0.bias", "1.running_mean", "1.running_var", "3.weight"} <= set(shadow.names)
    with torch.no_grad():
        net[0].bias.add_(1.0)
    frozen = net[0].weight.clone()
    shadow.update(0.3)
    assert torch.equal(shadow.state_dict()["0.weight"], frozen)
    assert not torch.equal(shadow.state_dict()["0.bias"], net[0].bias)


def test_ema_follows_buffers_but_not_counters():
    net = nn.Sequential(nn.Conv2d(2, 3, 1), nn.BatchNorm2d(3))
    shadow = ema.ModelEMA(net)
    assert "1.running_var" in shadow.names and "1.num_batches_tracked" not in shadow.names
    net.train()(torch.randn(4, 2, 5, 5))
    with torch.no_grad():
        net[0].weight.add_(1.0)
    old = [t.clone() for t in shadow.tensors]
    shadow.update(0.75)
    live = dict(net.state_dict())
    for name, e, o in zip(shadow.names, shadow.tensors, old):
        torch.testing.assert_close(e, 0.75 * o + 0.25 * live[name])
    assert shadow.state_dict()["1.num_batches_tracked"] == 1


def test_unported_optimizers_and_names():
    """Every optimizer name of the JAX registry builds the port's optimizer (RMSProp and Lion
    since they were ported); a name neither package registers raises, naming the registered ones."""
    params = [("w", nn.Parameter(torch.zeros(2, 2)))]
    for name, cls in (("RMSProp", RMSProp), ("rmsprop", RMSProp), ("RMSprop", RMSProp), ("Lion", Lion)):
        assert isinstance(build_optimizer(name, params), cls)
    with pytest.raises(KeyError, match="Lion.*RMSProp"):
        build_optimizer("Adagrad", params)
    with pytest.raises(KeyError, match="AdamW"):
        build_optimizer("AdamX", params)
    assert isinstance(build_optimizer("sgd", params), torch.optim.SGD)
    assert isinstance(build_optimizer("Adam", params, {"weight_decay": "1e-4"}), torch.optim.AdamW)


def _model_stub():
    return types.SimpleNamespace(net=Tiny(_values(1)), device=torch.device("cpu"))


@pytest.mark.parametrize("override,arg,error", [
    (dict(precise_bn=True), None, NotImplementedError),
    (dict(qat_params={"enabled": True}), None, NotImplementedError),
    (dict(sg_logger="wandb_sg_logger"), None, NotImplementedError),
    (dict(sg_logger="clearml_sg_logger"), None, NotImplementedError),
    (dict(sg_logger="dagshub_sg_logger"), None, NotImplementedError),
    (dict(sg_logger="deci_platform_sg_logger"), None, NotImplementedError),
    (dict(sg_logger_params={"monitor_system": True}), None, NotImplementedError),
    (dict(train_metrics_list=["DepthMAE"]), None, KeyError),
    (dict(valid_metrics_list=[{"DepthRMSE": {}}]), None, KeyError),
    (dict(valid_metrics_list=["DepthMSE"]), None, KeyError),
    (dict(valid_metrics_list=["DeltaMetric"]), None, KeyError),
    (dict(), "additional_callbacks", KeyError),
    (dict(phase_callbacks=["x"]), None, KeyError),
])
def test_unported_training_params_raise(override, arg, error, tmp_path):
    """What stays unported raises and names its ROADMAP item (an unknown callback
    name, in ``phase_callbacks`` or ``additional_callbacks``, raises KeyError listing the
    registered ones: every callback name of the JAX package is ported)."""
    kwargs = {arg: ["NoSuchCallback"]} if arg else {}
    match = "Unknown callback" if override.get("phase_callbacks") == ["x"] or arg else "ROADMAP"
    with pytest.raises(error, match=match):
        trainer.Trainer("t", ckpt_root_dir=str(tmp_path)).train(
            _model_stub(), dict(loss=lambda o, t: None, save_model=False, **override), [], **kwargs)


class _Recorder(callbacks.Callback):
    def __init__(self):
        self.events = []

    def on_validation_loader_end(self, ctx):
        self.events.append(("valid", ctx.epoch))

    def on_test_loader_end(self, ctx):
        self.events.append(("test", ctx.epoch))


def _tiny_batches():
    rng = np.random.RandomState(2)
    return [(torch.from_numpy(rng.randn(2, 2).astype(np.float32)), torch.zeros(2, 5)) for _ in range(2)]


class _TinyLinear(nn.Module):
    def __init__(self):
        super().__init__()
        self.heads = nn.Linear(2, 5)

    def forward(self, x):
        return self.heads(x)


@pytest.mark.parametrize("case", ["save_model_default", "resume", "run_id", "valid_loader", "test_loaders",
                                  "additional_callbacks", "valid_metrics_list"])
def test_ported_training_params_run(case, tmp_path):
    """What was refused before validation and checkpoints were ported now runs."""
    root = str(tmp_path)
    model = types.SimpleNamespace(net=_TinyLinear(), device=torch.device("cpu"), load_state_dict=lambda sd: None)
    params = dict(loss=lambda out, t: ((out - t).pow(2).mean(), {}), max_epochs=2, initial_lr=0.1)
    recorder = _Recorder()
    kwargs = {}
    if case == "resume":
        trainer.Trainer("t", ckpt_root_dir=root).train(model, dict(params, max_epochs=1), _tiny_batches())
        params.update(resume=True)
    elif case == "run_id":
        first = trainer.Trainer("t", ckpt_root_dir=root)
        first.train(model, dict(params, max_epochs=1), _tiny_batches())
        params.update(run_id=first.run_id)
    elif case in ("valid_loader", "valid_metrics_list"):
        kwargs["valid_loader"] = _tiny_batches()
        if case == "valid_metrics_list":
            params.update(loss=lambda out, t: (out.pred_scores.mean(), {}),
                          valid_metrics_list=[{"DetectionMetrics": {"num_cls": 1}}], metric_to_watch="mAP@0.50:0.95")
            model.net = _TinyDetector()
            kwargs["valid_loader"] = [(torch.zeros(2, 2), torch.tensor([[[0, 1, 1, 5, 5]]] * 2, dtype=torch.float32))]
    elif case == "test_loaders":
        kwargs["test_loaders"] = {"a": _tiny_batches()}
    elif case == "additional_callbacks":
        kwargs.update(additional_callbacks=[recorder, "TimerCallback", {"EarlyStop": {"monitor": "Loss"}}],
                      valid_loader=_tiny_batches())
    t = trainer.Trainer("t", ckpt_root_dir=root)
    t.train(model, params, _tiny_batches(), **kwargs)
    files = set(os.listdir(t.ckpt_dir))
    assert {"ckpt_latest.pth", "recipe.json", "events.jsonl"} <= files
    if case in ("resume", "run_id"):
        assert t.train_state.step == 4 and len(t.train_loss_history) == 1
    if case in ("valid_loader", "valid_metrics_list", "additional_callbacks"):
        assert len(t.valid_metrics_history) == 2 and "Loss" in t.valid_metrics_history[0]
    if case == "valid_metrics_list":
        assert t.valid_metrics_history[-1]["mAP@0.50:0.95"] == 1.0 and "ckpt_best.pth" in files
    if case == "test_loaders":
        assert len(t.test_metrics_history) == 2 and "Loss" in t.test_metrics_history[0]["a"]
    if case == "additional_callbacks":
        assert recorder.events == [("valid", 0), ("valid", 1)]


class _TinyDetector(nn.Module):
    """Emits one box [1, 1, 5, 5] of class 0 at score sigmoid(w), whatever the input."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(1))

    def forward(self, x):
        b = x.shape[0]
        boxes = torch.tensor([1.0, 1.0, 5.0, 5.0]).expand(b, 1, 4)
        return types.SimpleNamespace(pred_bboxes=boxes, pred_scores=torch.sigmoid(self.w).expand(b, 1, 1))


def test_training_runs_with_jax_blocked(tmp_path):
    """The training slice imports and takes CPU train steps with jax, flax, optax and
    the JAX package unavailable (as on the GPU machine), and never imports them."""
    import os
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(
        """
        import sys
        for name in ("jax", "flax", "optax", "cv2", "PIL", "super_gradients_tpu"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(2)
        import os, sys
        from super_gradients_tpu_torch import models
        from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer
        model = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu")
        before = {k: v.clone() for k, v in model.net.state_dict().items()}
        loader = torch.utils.data.DataLoader(RandomDetectionDataset(4, (64, 64), 4, 8), batch_size=2)
        trainer = Trainer("blocked", ckpt_root_dir=sys.argv[1])
        trainer.train(model, dict(max_epochs=1, loss="PPYoloELoss", criterion_params={"num_classes": 4},
                                  optimizer="AdamW", optimizer_params={"weight_decay": 1e-5}, initial_lr=2e-4,
                                  lr_mode="CosineLRScheduler", ema=True, mixed_precision=True,
                                  zero_weight_decay_on_bias_and_bn=True, metric_to_watch="mAP@0.50:0.95",
                                  valid_metrics_list=[{"DetectionMetrics": {"num_cls": 4}}]), loader, loader)
        changed = sum(not torch.equal(before[k], v) for k, v in model.net.state_dict().items())
        assert len(trainer.train_loss_history) == 1 and changed > 0, (trainer.train_loss_history, changed)
        assert "mAP@0.50:0.95" in trainer.valid_metrics_history[0], trainer.valid_metrics_history
        assert {"ckpt_latest.pth", "ckpt_best.pth", "average_model.pth"} <= set(os.listdir(trainer.ckpt_dir))
        assert not [m for m in ("jax", "flax", "optax", "super_gradients_tpu") if sys.modules.get(m) is not None]
        print("OK", trainer.train_loss_history[0])
        """
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=repo, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_default_training_params_match_the_yaml():
    from super_gradients_tpu.common.config import load_recipe

    assert trainer.DEFAULT_TRAINING_PARAMS == load_recipe("training_hyperparams/default_train_params.yaml")


def test_silent_drop_guard_reports_unread_keys(tmp_path):
    model = _model_stub()
    model.load_state_dict = lambda state_dict: None
    t = trainer.Trainer("t", ckpt_root_dir=str(tmp_path))
    t.train(model, dict(loss=lambda o, t: None, save_model=False, totally_bogus_knob=1), [])
    assert t.unconsumed_training_params == ["totally_bogus_knob"]
