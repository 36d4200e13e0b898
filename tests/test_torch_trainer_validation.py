"""Validation, callbacks, checkpoints and resume of the port's ``Trainer`` against
the JAX package's, on the CPU.

- ``Trainer.evaluate``: YOLO-NAS-S, 4 classes, 64x64, the JAX model's weights
  carried across by ``conversion/from_jax.py``; the targets are the JAX model's
  own detections jittered by a seeded offset, so that mAP is neither 0 nor 1. The
  NMS outputs are held to equal counts and labels, boxes within ``BOX_ATOL``
  (1e-2 px: the random-init network's logits reach |100|, and the two libraries'
  fp32 forwards differ by up to ~5e-3 px after the DFL decode, so 1e-4 cannot
  hold). The test asserts that no IoU threshold falls between the two sides'
  IoUs of any prediction with any target, and that the score ranks are the
  same, so every match decision is the same: then every metric of ``compute()``
  must agree within 1e-6 (absolute), and the validation ``Loss`` within
  ``rtol=1e-5`` (the train-loss tolerance of ``test_torch_train_step.py``).
- The event order of a whole ``train()`` run (validation every 2 epochs, a test
  loader every 3, phase callbacks for every phase, a callback that stops
  training): the same event sequence as the JAX trainer's, on a one-layer model
  of each library.
- ``EarlyStop``, ``BestCheckpointTracker`` and ``AverageBestModels`` on the same
  sequences as the JAX classes, NaN and ties included: equal decisions, and the
  averaged parameters equal bit for bit.
- Resume: 2 epochs straight equal bit for bit 1 epoch, then ``resume=True`` to 2
  (weights, EMA, AdamW moments, step, LR).
"""

import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.training import callbacks as jax_callbacks
from super_gradients_tpu.training import checkpoints as jax_checkpoints
from super_gradients_tpu.training.metrics import detection as jax_det
from super_gradients_tpu.training.trainer import Trainer as JaxTrainer
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer, callbacks, checkpoints
from super_gradients_tpu_torch.training.metrics import detection as det
from test_torch_yolo_nas import jax_numpy_variables

torch.set_num_threads(2)

NUM_CLASSES, IMAGE = 4, 64
METRICS = [{"DetectionMetrics": {"num_cls": NUM_CLASSES}},
           {"DetectionMetricsDistanceBased": {"num_cls": NUM_CLASSES, "distance_thresholds": [2.0, 4.0]}}]
LOSS = dict(loss="PPYoloELoss", criterion_params={"num_classes": NUM_CLASSES})
# the two libraries' fp32 forwards of the random-init network (logits up to |100|)
# differ by up to ~5e-3 px in the DFL-decoded boxes (tests/test_torch_predict.py: 5e-2)
BOX_ATOL = 1e-2


@pytest.fixture(scope="module")
def pair():
    jm = jax_models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE)
    v = jax_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    pm = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE, device="cpu")
    pm.net.load_state_dict(variables_from_jax_to_torch(v), strict=True)
    return jm, pm


def _jax_forward(jm, x):
    """The JAX model's eval-mode outputs, compiled as one program."""
    return jax.jit(lambda v, x: jm.module.apply(v, x, train=False))(jm.variables, jnp.asarray(x))


def _jittered_batches(jm, seed=0, n_batches=2, b=4, max_boxes=12):
    """Image batches (NHWC for JAX, NCHW for the port) whose targets are the JAX
    model's own detections at the metric's NMS, moved by a seeded offset."""
    rng = np.random.RandomState(seed)
    metric = jax_det.DetectionMetrics(num_cls=NUM_CLASSES)
    out = []
    for _ in range(n_batches):
        x = rng.rand(b, IMAGE, IMAGE, 3).astype(np.float32)
        nms = metric.preprocess_device(_jax_forward(jm, x), None)
        boxes, labels, nums = np.asarray(nms.boxes), np.asarray(nms.labels), np.asarray(nms.num_detections)
        targets = np.full((b, max_boxes, 5), -1.0, np.float32)
        for i in range(b):
            n = min(int(nums[i]), max_boxes)
            targets[i, :n, 0] = labels[i, :n]
            targets[i, :n, 1:5] = boxes[i, :n] + rng.randn(n, 4).astype(np.float32) * 2.0
        out.append((x, targets))
    return out


def test_evaluate_matches_jax(pair, tmp_path):
    jm, pm = pair
    jax_batches = _jittered_batches(jm)
    port_batches = [(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t)) for x, t in jax_batches]

    thresholds = np.linspace(0.5, 0.95, 10)
    for (x, t), (px, _) in zip(jax_batches, port_batches):
        ref = jax_det.DetectionMetrics(num_cls=NUM_CLASSES).preprocess_device(_jax_forward(jm, x), None)
        with torch.no_grad():
            got = det.DetectionMetrics(num_cls=NUM_CLASSES).preprocess_device(pm.net.eval()(px), None)
        np.testing.assert_array_equal(got.num_detections.numpy(), np.asarray(ref.num_detections))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=BOX_ATOL, rtol=0)
        for i in range(len(x)):
            n, valid = int(ref.num_detections[i]), t[i, :, 0] >= 0
            iou_ref = det._np_iou(np.asarray(ref.boxes[i, :n]), t[i, valid, 1:5])
            iou_got = det._np_iou(got.boxes[i, :n].numpy(), t[i, valid, 1:5])
            # no IoU threshold lies between the two sides' IoUs, so every match decision is the same
            assert np.array_equal(iou_ref[..., None] > thresholds, iou_got[..., None] > thresholds)
            assert np.array_equal(np.argsort(-np.asarray(ref.scores[i, :n]), kind="stable"),
                                  np.argsort(-got.scores[i, :n].numpy(), kind="stable"))

    ref = JaxTrainer("eval", ckpt_root_dir=str(tmp_path)).evaluate(jm, jax_batches, LOSS, metrics_list=METRICS)
    got = Trainer("eval", ckpt_root_dir=str(tmp_path)).evaluate(pm, port_batches, LOSS, metrics_list=METRICS)
    assert set(got) == set(ref)
    assert 0.05 < got["mAP@0.50:0.95"] < 0.95 and 0.05 < got["mAP@dist2:4"] < 0.95
    for k in ref:
        if k == "Loss":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)
        else:
            assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])
    tested = Trainer("eval", ckpt_root_dir=str(tmp_path)).test(pm, port_batches, test_metrics_list=METRICS[:1])
    assert tested["mAP@0.50:0.95"] == got["mAP@0.50:0.95"] and "Loss" not in tested


# ------------------------------------------------------------------ callbacks


class _JaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Dense(2)(x.reshape((x.shape[0], -1)))


def _recorders(base_callback, base_phase_callback, phase_enum, log):
    class Recorder(base_callback):
        pass

    def make(event):
        return lambda self, ctx: log.append((event, ctx.epoch, ctx.batch_idx))

    for event in ("on_training_start", "on_train_loader_start", "on_train_batch_start", "on_train_batch_end",
                  "on_train_loader_end", "on_validation_loader_start", "on_validation_batch_end",
                  "on_validation_loader_end", "on_test_loader_end", "on_training_end"):
        setattr(Recorder, event, make(event))

    class PhaseRecorder(base_phase_callback):
        def __call__(self, ctx):
            log.append(("phase", self.phase.value, ctx.epoch))

    class Stopper(base_callback):
        def on_validation_loader_end(self, ctx):
            if ctx.epoch == 3:
                ctx.stop_training = True

    return [Recorder(), Stopper()] + [PhaseRecorder(p) for p in phase_enum]


def test_callback_events_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    batches = [(rng.randn(4, 2, 2, 2).astype(np.float32), rng.randn(4, 2).astype(np.float32)) for _ in range(3)]
    params = dict(max_epochs=6, run_validation_freq=2, run_test_freq=3, save_model=False, initial_lr=0.1)

    jax_log, port_log = [], []
    module = _JaxTiny()
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((4, 8)))
    jm = types.SimpleNamespace(params=variables["params"], batch_stats={}, module=module, variables=variables,
                               name="tiny", update_variables=lambda v: None)
    JaxTrainer("events", ckpt_root_dir=str(tmp_path / "jax")).train(
        jm, dict(params, loss=lambda out, t: (jnp.mean((out - t) ** 2), {})), batches, valid_loader=batches[:2],
        test_loaders={"t": batches[:1]},
        additional_callbacks=_recorders(jax_callbacks.Callback, jax_callbacks.PhaseCallback, jax_callbacks.Phase, jax_log))

    port_batches = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches]
    pm = types.SimpleNamespace(net=nn.Sequential(nn.Flatten(), nn.Linear(8, 2)), device=torch.device("cpu"),
                               load_state_dict=lambda sd: None, name="tiny")
    Trainer("events", ckpt_root_dir=str(tmp_path / "port")).train(
        pm, dict(params, loss=lambda out, t: (torch.mean((out - t) ** 2), {})), port_batches,
        valid_loader=port_batches[:2], test_loaders={"t": port_batches[:1]},
        additional_callbacks=_recorders(callbacks.Callback, callbacks.PhaseCallback, callbacks.Phase, port_log))

    assert port_log == jax_log
    epochs = sorted({e for ev, e, _ in port_log if ev == "on_train_loader_start"})
    assert epochs == [0, 1, 2, 3]  # stopped after epoch 3's validation, before epoch 4
    assert [e for ev, e, _ in port_log if ev == "on_validation_loader_end"] == [1, 3]
    assert [e for ev, e, _ in port_log if ev == "on_test_loader_end"] == [2]
    assert sum(ev == "phase" for ev, _, _ in port_log) > 10


def test_phase_callback_routes_one_event():
    calls = []

    class Cb(callbacks.PhaseCallback):
        def __call__(self, ctx):
            calls.append(self.phase)

    ctx = callbacks.PhaseContext()
    for phase, event in callbacks.PhaseCallback._PHASE_TO_EVENT.items():
        cb, calls[:] = Cb(phase), []
        for other in callbacks.PhaseCallback._PHASE_TO_EVENT.values():
            getattr(cb, other)(ctx)
        assert calls == [phase], event
    assert callbacks.PhaseCallback._PHASE_TO_EVENT == {
        callbacks.Phase(p.value): e for p, e in jax_callbacks.PhaseCallback._PHASE_TO_EVENT.items()}


EARLY_STOP_SEQ = [0.1, 0.3, 0.3, 0.25, 0.31, 0.31, 0.2, float("nan"), 0.5]


@pytest.mark.parametrize("kw", [dict(mode="max", patience=2), dict(mode="min", patience=1),
                                dict(mode="max", patience=2, min_delta=0.05), dict(mode="max", check_finite=False)])
def test_early_stop_matches_jax(kw):
    got_cb = callbacks.EarlyStop(monitor="m", **kw)
    ref_cb = jax_callbacks.EarlyStop(monitor="m", **kw)
    got, ref = [], []
    for v in EARLY_STOP_SEQ:
        for cb, ctx_cls, out in ((got_cb, callbacks.PhaseContext, got), (ref_cb, jax_callbacks.PhaseContext, ref)):
            ctx = ctx_cls(valid_metrics={"m": v})
            cb.on_validation_loader_end(ctx)
            out.append((ctx.stop_training, cb.count, cb.best))
    assert str(got) == str(ref)  # str: NaN == NaN
    assert any(s for s, _, _ in got)


def test_callback_names_resolve_or_point_to_the_roadmap():
    assert isinstance(callbacks.resolve_callback("EarlyStop"), callbacks.EarlyStop)
    cb = callbacks.resolve_callback({"PPYoloETrainingStageSwitchCallback": {"static_assigner_end_epoch": 3}})
    assert cb.static_assigner_end_epoch == 3
    for name in callbacks.NOT_PORTED:
        with pytest.raises(KeyError, match="ROADMAP"):
            callbacks.resolve_callback(name)
    with pytest.raises(KeyError, match="Unknown callback"):
        callbacks.resolve_callback("NoSuchCallback")
    from super_gradients_tpu.common.registry import CALLBACKS as JAX_CALLBACKS
    from super_gradients_tpu_torch.common.registry import CALLBACKS

    assert set(JAX_CALLBACKS) == set(CALLBACKS) | set(callbacks.NOT_PORTED)


# --------------------------------------------------------------- checkpoints

METRIC_SEQS = {
    "ties": [0.1, 0.3, 0.3, 0.2, 0.3, 0.05],
    "nan": [0.2, float("nan"), 0.4, float("nan"), 0.1, 0.4],
    "first_nan": [float("nan"), 0.5, 0.5, 0.7, 0.6],
}


@pytest.mark.parametrize("greater", [True, False])
@pytest.mark.parametrize("seq", list(METRIC_SEQS))
def test_best_tracker_and_average_match_jax(seq, greater):
    values = METRIC_SEQS[seq]
    got_t, ref_t = checkpoints.BestCheckpointTracker(greater), jax_checkpoints.BestCheckpointTracker(greater)
    assert [got_t.is_improvement(v) for v in values] == [ref_t.is_improvement(v) for v in values]
    assert str(got_t.best) == str(ref_t.best)

    rng = np.random.RandomState(1)
    snaps = [{"w": rng.randn(3, 5).astype(np.float32), "b": rng.randn(7).astype(np.float32)} for _ in values]
    got_a = checkpoints.AverageBestModels(n_best=3, greater_is_better=greater)
    ref_a = jax_checkpoints.AverageBestModels(n_best=3, greater_is_better=greater)
    for v, s in zip(values, snaps):
        got_a.update(v, {k: torch.from_numpy(a) for k, a in s.items()})
        ref_a.update(v, s)
        assert str([m for m, _ in got_a.snapshots]) == str([m for m, _ in ref_a.snapshots])
    got, ref = got_a.averaged_params(), ref_a.averaged_params()
    for k in ref:
        assert np.array_equal(got[k].numpy(), ref[k]), k


def test_transfer_weights_takes_matching_names_and_shapes():
    dst = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    src = {"a": torch.ones(2), "b": torch.ones(4), "d": torch.ones(1)}
    out = checkpoints.transfer_weights(src, dst)
    assert out["a"].sum() == 2 and out["b"].sum() == 0 and out["c"].sum() == 0
    assert checkpoints.transfer_weights.last_transferred == 1


B = 4
TRAIN = dict(max_epochs=2, **LOSS, optimizer="AdamW", optimizer_params={"weight_decay": 1e-4}, initial_lr=1e-3,
             lr_mode="CosineLRScheduler", cosine_final_lr_ratio=0.1, ema=True,
             ema_params={"decay": 0.9, "decay_type": "exp", "beta": 4}, valid_metrics_list=METRICS[:1],
             metric_to_watch="mAP@0.50:0.95", save_ckpt_epoch_list=[0], silent_mode=True)


def _model():
    model = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE, device="cpu", seed=3)
    for name, module in model.net.named_modules():
        if name.endswith("cls_pred"):
            module.bias.data.zero_()
    return model


def _loaders():
    mk = lambda n: torch.utils.data.DataLoader(RandomDetectionDataset(n, (IMAGE, IMAGE), NUM_CLASSES, 8), batch_size=B)  # noqa: E731
    return mk(2 * B), mk(B)


class _StopAfterFirstEpoch(callbacks.Callback):
    def on_train_loader_end(self, ctx):
        ctx.stop_training = True


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    train_loader, valid_loader = _loaders()
    straight = Trainer("straight", ckpt_root_dir=root)
    straight.train(_model(), TRAIN, train_loader, valid_loader)
    first = Trainer("resumed", ckpt_root_dir=root)
    first.train(_model(), TRAIN, train_loader, valid_loader, additional_callbacks=[_StopAfterFirstEpoch()])
    second = Trainer("resumed", ckpt_root_dir=root)
    model = second.train(_model(), dict(TRAIN, resume=True), train_loader, valid_loader)
    return straight, first, second, model


def test_resume_is_bit_equal_to_an_uninterrupted_run(resumed):
    straight, first, second, _ = resumed
    assert first.train_state.step == 2 and len(first.train_loss_history) == 1
    assert second.run_id == first.run_id and second.train_loss_history == straight.train_loss_history[1:]
    a, b = straight.train_state, second.train_state
    assert a.step == b.step == 4
    for x, y in ((a.net.state_dict(), b.net.state_dict()), (a.ema.state_dict(), b.ema.state_dict())):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert [g["lr"] for g in oa["param_groups"]] == [g["lr"] for g in ob["param_groups"]]
    for i, sa in oa["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], ob["state"][i][key]), (i, key)
    assert straight.valid_metrics_history[1] == second.valid_metrics_history[0]


def test_checkpoint_files_and_layout(resumed, pair):
    straight, _, _, _ = resumed
    names = set(os.listdir(straight.ckpt_dir))
    assert {"ckpt_latest.pth", "ckpt_best.pth", "ckpt_epoch_0.pth", "average_model.pth", "recipe.json",
            "events.jsonl"} <= names
    ckpt = torch.load(os.path.join(straight.ckpt_dir, "ckpt_latest.pth"), weights_only=True)
    assert {"net", "ema_net", "optimizer_state_dict", "epoch", "metrics", "step", "experiment", "ckpt_version"} <= set(ckpt)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 4 and ckpt["metrics"] == straight.valid_metrics_history[1]
    assert checkpoints.load_metadata(straight.ckpt_dir, "ckpt_latest")["epoch"] == 1

    # the names are the original super-gradients ones that the JAX package's converter reads
    from super_gradients_tpu.conversion.torch_converter import convert_state_dict, yolo_nas_key_mapper

    jm, _ = pair
    best = torch.load(os.path.join(straight.ckpt_dir, "ckpt_best.pth"), weights_only=True)["ema_net"]
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)))
    back = convert_state_dict(best, template, rules=yolo_nas_key_mapper(), strict=True)
    carried = variables_from_jax_to_torch(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), back))
    keys = [k for k in carried if not k.endswith("num_batches_tracked")]  # a counter JAX does not keep
    assert len(keys) > 400 and all(torch.equal(carried[k], best[k]) for k in keys)

    model = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE, device="cpu",
                       checkpoint_path=os.path.join(straight.ckpt_dir, "ckpt_best.pth"))
    assert all(torch.equal(v, best[k]) for k, v in model.net.state_dict().items())


def test_average_model_pairs_averaged_parameters_with_live_bn(resumed):
    """As the JAX trainer does: the mean of the best EMA parameters, with the LIVE
    network's BN statistics (not the EMA's), a divergence from the original
    super-gradients recorded in ROADMAP.md."""
    straight, _, _, _ = resumed
    avg = torch.load(os.path.join(straight.ckpt_dir, "average_model.pth"), weights_only=True)["net"]
    ema0 = torch.load(os.path.join(straight.ckpt_dir, "ckpt_epoch_0.pth"), weights_only=True)["ema_net"]
    ema1, live = straight.train_state.ema.state_dict(), straight.train_state.net.state_dict()
    params = {name for name, _ in straight.train_state.net.named_parameters()}
    for k, v in avg.items():
        if k in params:
            acc = ema0[k].clone()
            acc += ema1[k]
            assert torch.equal(v, acc / 2), k
        else:
            assert torch.equal(v, live[k]), k
    assert any(not torch.equal(live[k], ema1[k]) for k in avg if k.endswith("running_var"))


def test_models_hand_back_ema_and_stage_switch(resumed, tmp_path):
    _, _, second, model = resumed
    assert all(torch.equal(v, second.train_state.ema.state_dict()[k]) for k, v in model.net.state_dict().items())

    seen = []

    class Assigner(callbacks.Callback):
        def on_train_batch_start(self, ctx):
            seen.append((ctx.epoch, ctx.criterion.use_static_assigner))

    train_loader, _ = _loaders()
    Trainer("switch", ckpt_root_dir=str(tmp_path)).train(
        _model(), dict(TRAIN, criterion_params={"num_classes": NUM_CLASSES, "use_static_assigner": True},
                       phase_callbacks=[{"PPYoloETrainingStageSwitchCallback": {"static_assigner_end_epoch": 1}}],
                       valid_metrics_list=[], save_model=False, max_train_batches=1),
        train_loader, additional_callbacks=[Assigner()])
    assert seen == [(0, True), (1, False)]
