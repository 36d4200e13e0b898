"""Pose training and validation of the port against the JAX package's.

YOLO-NAS-POSE-N, 17 joints, 64x64, B=4, the JAX weights carried across.

- Two ``Trainer.train`` steps on the same two ``RandomPoseDataset`` batches (1 epoch, no
  shuffle), fp32, ``YoloNASPoseLoss``, in the regime and with the bounds of
  ``tests/test_torch_train_step.py`` (the detection comparison): SGD with small steps, both fp32
  runs held to the port's fp64 run of the same steps by the L2 distance over each group
  (weights, BN running means, BN running variances; live and EMA), the port's no further
  than twice the JAX run's plus fp32 resolution, the JAX run's within 10% of the distance
  the steps moved; ``train_loss_history`` ``rtol=1e-5``.
- ``Trainer.evaluate`` with ``PoseEstimationMetrics`` and the loss on batches whose
  targets are the JAX model's own poses moved by a seeded offset: AP and AR within 1e-6
  of the JAX ``Trainer.evaluate``, ``Loss`` ``rtol=1e-5``.
- One validated epoch on ``pose_test_dataloader`` with ``metric_to_watch: AP``: finite
  results and a best checkpoint.
- One bf16 step: its loss within ``rtol=0.05`` of the fp32 loss (the tolerance of the
  detection test), parameters, EMA and BN buffers fp32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu.training.metrics import pose_estimation as jax_pose_metrics
from super_gradients_tpu.training.trainer import Trainer as JaxTrainer
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import YOLO_NAS_POSE_RULES, variables_from_jax_to_torch
from super_gradients_tpu_torch.training import Trainer, dataloaders
from test_torch_pose_model import jax_pose_numpy_variables
from test_torch_train_step import GROUPS, _distance, _zero_variance_gain
from torch_jax_init import jax_model

torch.set_num_threads(2)

B, IMAGE, J, MAX_POSES = 4, 64, 17, 8
PARAMS = dict(
    max_epochs=1, loss="YoloNASPoseLoss", criterion_params={"num_joints": J},
    optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 1e-4}, zero_weight_decay_on_bias_and_bn=True,
    initial_lr=1e-3, lr_mode="CosineLRScheduler", cosine_final_lr_ratio=0.1, warmup_mode="LinearBatchLRWarmup",
    lr_warmup_steps=1, warmup_initial_lr=1e-4, ema=True, ema_params={"decay": 0.9, "decay_type": "threshold"},
    clip_grad_norm=1.0, save_model=False,
)
METRICS = [{"PoseEstimationMetrics": {"num_joints": J}}]


def _port_loader():
    return torch.utils.data.DataLoader(dataloaders.RandomPoseDataset(2 * B, (IMAGE, IMAGE), J, MAX_POSES), batch_size=B)


def _port_model(variables):
    model = models.get("yolo_nas_pose_n", image_size=IMAGE, device="cpu")
    model.net.load_state_dict(variables_from_jax_to_torch(variables, rules=YOLO_NAS_POSE_RULES), strict=True)
    return model


@pytest.fixture(scope="module")
def jax_pair():
    jm = jax_model("yolo_nas_pose_n", image_size=IMAGE)
    return jm, jax_pose_numpy_variables(jm)


@pytest.fixture(scope="module")
def runs(jax_pair, tmp_path_factory):
    _, v = jax_pair
    jm = jax_model("yolo_nas_pose_n", variables=v, image_size=IMAGE)
    loader = jax_dataloaders.DataLoader(jax_dataloaders.RandomPoseDataset(2 * B, (IMAGE, IMAGE), J, MAX_POSES),
                                        batch_size=B)
    jt = JaxTrainer("pose_parity", ckpt_root_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt.train(jm, dict(PARAMS, valid_metrics_list=[]), loader)

    root = str(tmp_path_factory.mktemp("port_ckpt"))
    pm = _port_model(v)
    pt = Trainer("pose_parity", ckpt_root_dir=root)
    pt.train(pm, PARAMS, _port_loader())
    ref = _port_model(v)  # the same run in fp64: the reference both fp32 runs are held to
    ref.net.double()
    rt = Trainer("pose_parity_fp64", ckpt_root_dir=root)
    rt.train(ref, PARAMS, [(images.double(), targets.double()) for images, targets in _port_loader()])
    st = jt.train_state
    return dict(
        v0=v, jax_trainer=jt, port_trainer=pt, ref_trainer=rt,
        states={  # (JAX fp32, port fp32, port fp64) weights and buffers
            "ema": (jm.variables, pm.net.state_dict(), ref.net.state_dict()),
            "live": ({"params": st.params, "batch_stats": st.batch_stats}, pt.train_state.net.state_dict(),
                     rt.train_state.net.state_dict()),
        },
    )


def _bn_inputs_per_channel():
    """n = B*H*W of each BN's input in the train forward, by state_dict prefix."""
    net = models.get("yolo_nas_pose_n", image_size=IMAGE, device="cpu").net.train()
    sizes = {}
    hooks = [m.register_forward_pre_hook(lambda mod, inp, name=name: sizes.__setitem__(name, inp[0].numel() // inp[0].shape[1]))
             for name, m in net.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        net(torch.zeros(B, 3, IMAGE, IMAGE))
    for h in hooks:
        h.remove()
    return sizes


def _jax_in_torch_terms(jax_vars, v0, sizes, ema):
    """The JAX state as a torch state_dict, running variances made unbiased (torch updates
    them with the unbiased batch variance, flax with the biased one)."""
    out = variables_from_jax_to_torch(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_vars)),
                                      rules=YOLO_NAS_POSE_RULES)
    gain = _zero_variance_gain(2, ema)
    for key in [k for k in out if k.endswith("running_var")]:
        n = sizes[key[: -len(".running_var")]]
        c = n / (n - 1)
        out[key] = c * out[key].double() + (1 - c) * gain * v0[key].double()
    return out


@pytest.mark.parametrize("which", ["ema", "live"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_weights_and_bn_buffers_match_jax(runs, which, group):
    v0 = variables_from_jax_to_torch(runs["v0"], rules=YOLO_NAS_POSE_RULES)
    jax_vars, port, ref = runs["states"][which]
    jax_t = _jax_in_torch_terms(jax_vars, v0, _bn_inputs_per_channel(), ema=which == "ema")
    keys = [k for k in ref if GROUPS[group](k)]
    assert set(jax_t) == set(port) == set(ref)
    e_jax, e_port = _distance(jax_t, ref, keys), _distance(port, ref, keys)
    floor = 1e-7 * _distance(ref, {k: torch.zeros(()) for k in keys}, keys)
    moved = _distance(ref, v0, keys)
    assert moved > 10 * floor  # the two steps moved the group
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


def _jittered_pose_batches(jm, seed=0, n_batches=2, b=4):
    """Image batches (NHWC for JAX, NCHW for the port) whose targets are the JAX model's
    own poses at the metric's NMS (every joint visible), moved by a seeded offset."""
    rng = np.random.RandomState(seed)
    metric = jax_pose_metrics.PoseEstimationMetrics(num_joints=J, post_prediction_conf=0.3)
    forward = jax.jit(lambda v, x: jm.module.apply(v, x, train=False))
    out = []
    for _ in range(n_batches):
        x = rng.rand(b, IMAGE, IMAGE, 3).astype(np.float32)
        nms = metric.preprocess_device(forward(jm.variables, jnp.asarray(x)), None)
        poses, boxes, nums = np.asarray(nms.poses), np.asarray(nms.boxes), np.asarray(nms.num_detections)
        targets = np.full((b, MAX_POSES, 5 + 3 * J), -1.0, np.float32)
        for i in range(b):
            n = min(int(nums[i]), MAX_POSES)
            kp = poses[i, :n].copy()
            kp[..., :2] += rng.randn(n, J, 2).astype(np.float32) * 1.5
            kp[..., 2] = 2.0
            targets[i, :n, 0] = 0.0
            targets[i, :n, 1:5] = boxes[i, :n]
            targets[i, :n, 5:] = kp.reshape(n, -1)
        out.append((x, targets))
    return out


def test_evaluate_matches_jax(jax_pair, tmp_path):
    jm, v = jax_pair
    pm = _port_model(v)
    jax_batches = _jittered_pose_batches(jm)
    port_batches = [(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t)) for x, t in jax_batches]
    loss = {"loss": "YoloNASPoseLoss", "criterion_params": {"num_joints": J}}
    ref = JaxTrainer("eval", ckpt_root_dir=str(tmp_path)).evaluate(jm, jax_batches, loss, metrics_list=METRICS)
    got = Trainer("eval", ckpt_root_dir=str(tmp_path)).evaluate(pm, port_batches, loss, metrics_list=METRICS)
    assert set(got) == set(ref) == {"AP", "AR", "Loss"}
    assert 0.05 < got["AP"] < 0.95
    for k in ref:
        if k == "Loss":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)
        else:
            assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])


def test_validated_epoch_on_pose_test_dataloader(jax_pair, tmp_path):
    """``Trainer.train`` with a validation pass through ``PoseEstimationMetrics`` after the
    epoch, ``metric_to_watch: AP``, checkpoints written."""
    _, v = jax_pair
    model = _port_model(v)
    train = dataloaders.get("pose_test_dataloader", dataloader_params={"batch_size": B, "dataset_size": 2 * B})
    valid = dataloaders.get("pose_test_dataloader", dataloader_params={"batch_size": B, "dataset_size": B})
    params = dict(PARAMS, save_model=True, valid_metrics_list=METRICS, metric_to_watch="AP",
                  sg_logger_params={"tensorboard": False})
    trainer = Trainer("pose_epoch", ckpt_root_dir=str(tmp_path))
    trainer.train(model, params, train, valid)
    (results,) = trainer.valid_metrics_history
    assert set(results) == {"AP", "AR", "Loss"} and all(np.isfinite(list(results.values())))
    assert os.path.exists(os.path.join(trainer.ckpt_dir, "ckpt_best.pth")) and trainer.best_metric == results["AP"]


def test_bf16_step_tracks_fp32_loss(jax_pair, tmp_path):
    _, v = jax_pair
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
