"""Trainer (counterpart of ``super_gradients_tpu/training/trainer.py``).

``Trainer(...).train(model, training_params, train_loader, valid_loader, test_loaders,
additional_callbacks)`` trains a copy of ``model.net`` on the model's device (the
GPU unless the caller passes a CPU model) and hands the EMA weights (or the live
ones without EMA) back through ``model.load_state_dict``. Each batch is one
micro-step of :class:`TrainStep`: forward under the bf16 policy, the registered loss
(``PPYoloELoss``, ``YoloNASPoseLoss``) in fp32, backward; every ``batch_accumulate``
micro-steps the mean gradient is clipped, the LR set from the schedule and the
optimizer and EMA stepped, as optax ``MultiSteps`` does.

Around the steps, as in the JAX trainer: validation every ``run_validation_freq``
epochs and at the last one (EMA weights, eval-mode BN, the training's bf16 policy,
outputs cast to fp32 before the loss and the metrics; ``DetectionMetrics`` and
``PoseEstimationMetrics`` run ``batched_nms`` / ``batched_pose_nms`` on the device,
kernel K1 on a GPU, and match on the host),
``test_loaders``, ``train_metrics_list``, phase callbacks, the experiment logger,
``.pth`` checkpoints (``ckpt_latest``, ``ckpt_best``, ``ckpt_epoch_N``,
``average_model``) in ``<ckpt_root_dir>/<experiment>/RUN_<ts>/`` with
``recipe.json``, and ``resume``. ``evaluate`` and ``test`` run the eval loop alone.
A uint8 batch is standardized on the device by the ``max_value`` of its loader, or
failing that of the loader's dataset (so a plain ``torch.utils.data.DataLoader`` over a
port dataset trains).

From a recipe: ``Trainer.train_from_config(cfg)`` builds the recipe's model (on its
``device``, the GPU by default) and loaders and trains; ``evaluate_checkpoint`` and
``resume_experiment`` rebuild them from a run's ``recipe.json``.

Data parallelism (as the JAX trainer's mesh): inside a ``torch.distributed`` process
group (``parallel/mesh.py::setup_device``) the train copy's BatchNorms take their
statistics over the global batch (``parallel/sync_batch_norm.py``) and it trains wrapped
in ``DistributedDataParallel``; each rank steps on its slice of every global batch, the
losses normalize over the global batch, the logged losses and every metric are global,
and only rank 0 writes checkpoints, ``recipe.json`` and the logs.

Knowledge distillation: a ``kd_module`` model (``training/losses/kd_losses.py::KDModule``)
trains through the plain ``Trainer`` with its ``teacher`` frozen (no update, no weight decay,
eval mode) and its metrics read the student's outputs; ``training/kd_trainer.py::KDTrainer``
builds the composite from a student and a teacher and hands the student back.

Precise BN and QAT are not ported yet: a training parameter that asks for one of them
raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from super_gradients_tpu_torch.common.environment import (
    barrier,
    generate_run_id,
    get_checkpoints_dir_path,
    get_latest_run_id,
    get_world_size,
    is_primary_process,
    process_group_active,
)
from super_gradients_tpu_torch.common.sg_loggers import get_sg_logger
from super_gradients_tpu_torch.parallel.collectives import broadcast_from_primary, global_sum, is_distributed
from super_gradients_tpu_torch.parallel.sync_batch_norm import convert_batch_norm
from super_gradients_tpu_torch.training import checkpoints as ckpt_utils
from super_gradients_tpu_torch.training import dataloaders
from super_gradients_tpu_torch.training.callbacks import Callback, CallbackHandler, PhaseContext, resolve_callback
from super_gradients_tpu_torch.training.ema import ModelEMA, make_decay_fn
from super_gradients_tpu_torch.training.losses import get_loss
from super_gradients_tpu_torch.training.metrics import MetricCollection, get_metric, to_host
from super_gradients_tpu_torch.training.mixed_precision import autocast, to_f32
from super_gradients_tpu_torch.training.optimizers import build_optimizer
from super_gradients_tpu_torch.training.pre_launch_callbacks import resolve_pre_launch_callback
from super_gradients_tpu_torch.training.schedules import build_lr_schedule
from super_gradients_tpu_torch.training.train_state import TrainState

logger = logging.getLogger(__name__)

# super_gradients_tpu/recipes/training_hyperparams/default_train_params.yaml, as a dict
DEFAULT_TRAINING_PARAMS: Dict = {
    "resume": False,
    "run_id": None,
    "resume_path": None,
    "ckpt_name": "ckpt_latest",
    "max_epochs": 1,
    "initial_lr": 0.01,
    "lr_mode": None,
    "lr_schedule_function": None,
    "lr_warmup_epochs": 0,
    "lr_warmup_steps": 0,
    "lr_cooldown_epochs": 0,
    "warmup_initial_lr": None,
    "step_lr_update_freq": None,
    "cosine_final_lr_ratio": 0.01,
    "warmup_mode": "LinearEpochLRWarmup",
    "lr_updates": [],
    "lr_decay_factor": 0.1,
    "optimizer": "SGD",
    "optimizer_params": {},
    "load_opt_params": True,
    "zero_weight_decay_on_bias_and_bn": False,
    "loss": None,
    "criterion_params": {},
    "ema": False,
    "ema_params": {"decay": 0.9999, "decay_type": "exp", "beta": 15},
    "train_metrics_list": [],
    "valid_metrics_list": [],
    "metric_to_watch": "Accuracy",
    "greater_metric_to_watch_is_better": True,
    "precise_bn": False,
    "precise_bn_batch_size": None,
    "cross_replica_bn": False,
    "silent_mode": False,
    "mixed_precision": False,
    "save_ckpt_epoch_list": [],
    "average_best_models": True,
    "batch_accumulate": 1,
    "run_validation_freq": 1,
    "run_test_freq": 1,
    "save_model": True,
    "seed": 42,
    "phase_callbacks": [],
    "clip_grad_norm": None,
    "ckpt_best_name": "ckpt_best",
    "max_train_batches": None,
    "max_valid_batches": None,
    "sg_logger": "base_sg_logger",
    "sg_logger_params": {"monitor_system": False},
    "_convert_": "all",
}

_LATER = "ROADMAP.md queue 1, 'Breadth' and 'Deployment and scale-out'"


class _TrackedParams(dict):
    """training_params that records which keys were read: a key that nothing read
    is reported at the end of ``train()`` (the silent-drop guard)."""

    _IGNORED = frozenset({"_convert_"})

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._read_keys = set()

    def __getitem__(self, k):
        self._read_keys.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._read_keys.add(k)
        return super().get(k, default)

    def unread_keys(self) -> List[str]:
        return sorted(set(self) - self._read_keys - self._IGNORED)


def _refuse_unported(tp: _TrackedParams) -> None:
    for name, asked in (("precise_bn", bool(tp.get("precise_bn"))),
                        ("qat_params", bool((tp.get("qat_params") or {}).get("enabled")))):
        if asked:
            raise NotImplementedError(
                f"Trainer.train: `{name}` asks for a feature that super_gradients_tpu_torch does not have yet ({_LATER})")


def _metrics_view(out):
    """Metrics evaluate the student of a KD composite output."""
    return out.student_output if hasattr(out, "student_output") else out


def channels_last_training(device: torch.device, mixed_precision: bool) -> bool:
    """Whether a train copy and its batches take channels_last: on a GPU under the bf16 policy
    only. An fp32 network there stays NCHW, because cuDNN's channels_last train-mode BatchNorm
    (its persistent NHWC kernel, which no TF32 switch governs) puts fp32 gradients ~1e-3 off
    fp64 where NCHW stays within fp32 rounding (a ResNet-18-CIFAR step on an H100: 0.117 against
    7.7e-5, the CPU's 3.0e-5, in gradient L2 distance)."""
    return device.type == "cuda" and mixed_precision


def _images_to_device(images: torch.Tensor, device: torch.device, max_value: Optional[float] = None,
                      channels_last: bool = True) -> torch.Tensor:
    """A host image batch onto the device: a pinned copy ``non_blocking``, channels_last on
    a GPU unless ``channels_last`` is off. A uint8 batch is standardized there,
    ``x * float32(1 / max_value)`` in float32, bit-equal to the host's ``DetectionStandardize``;
    a float batch passes unchanged."""
    images = images.to(device, non_blocking=True)
    if images.dtype == torch.uint8:
        if max_value is None:
            raise ValueError("a uint8 image batch needs a `max_value` on its loader or its loader's dataset "
                             "to be standardized on the device")
        images = images.float().mul_(float(np.float32(1.0 / max_value)))
    if device.type == "cuda" and channels_last:
        images = images.contiguous(memory_format=torch.channels_last)
    return images


def _to_device(images: torch.Tensor, targets: torch.Tensor, device: torch.device, max_value: Optional[float] = None,
               channels_last: bool = True):
    """A host batch onto the device: :func:`_images_to_device` and the targets as they are."""
    return _images_to_device(images, device, max_value, channels_last), targets.to(device, non_blocking=True)


class TrainStep:
    """One micro-step of the train loop, in the four parts ``chip_smoke.py`` times:
    :meth:`forward`, :meth:`loss`, :meth:`backward` and :meth:`update`. With ``ddp`` (the
    ``DistributedDataParallel`` wrapper of ``state.net``) the forward runs through it, and
    the backward all-reduces the gradients on the last micro-step of each accumulation."""

    def __init__(self, state: TrainState, criterion: Callable, lr_schedule: Callable[[float], float],
                 batch_accumulate: int = 1, clip_grad_norm: Optional[float] = None,
                 ema_decay: Optional[Callable[[float], float]] = None, mixed_precision: bool = False,
                 ddp: Optional[torch.nn.parallel.DistributedDataParallel] = None):
        self.state = state
        self.ddp = ddp
        self.criterion = criterion
        self.lr_schedule = lr_schedule
        self.batch_accumulate = batch_accumulate
        self.clip_grad_norm = clip_grad_norm
        self.ema_decay = ema_decay
        self.mixed_precision = mixed_precision
        self.device = next(state.net.parameters()).device
        self._params = [p for g in state.optimizer.param_groups for p in g["params"]]

    def forward(self, images: torch.Tensor):
        """The network's outputs under the bf16 policy, cast to fp32."""
        net = self.state.net
        if self.ddp is not None:
            # what DDP's no_sync() sets: the micro-steps before an accumulation's last keep their gradients local
            self.ddp.require_backward_grad_sync = (self.state.step + 1) % self.batch_accumulate == 0
            net = self.ddp
        with autocast(self.device, self.mixed_precision):
            out = net(images)
        return to_f32(out)

    def loss(self, outputs, targets: torch.Tensor):
        return self.criterion(outputs, targets)

    def backward(self, loss: torch.Tensor) -> None:
        loss.backward()

    @torch.no_grad()
    def update(self) -> None:
        """Count the micro-step; at the end of each accumulation, step the optimizer
        on the mean gradient and the EMA with the decay of the step before."""
        st = self.state
        st.step += 1
        if st.step % self.batch_accumulate:
            return
        opt_step = st.step // self.batch_accumulate - 1
        grads = [p.grad for p in self._params if p.grad is not None]
        if self.batch_accumulate > 1:
            torch._foreach_div_(grads, float(self.batch_accumulate))
        if self.clip_grad_norm:
            _clip_by_global_norm_(grads, float(self.clip_grad_norm))
        lr = self.lr_schedule(opt_step)
        for group in st.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
        st.optimizer.step()
        st.optimizer.zero_grad(set_to_none=True)
        if st.ema is not None:
            st.ema.update(self.ema_decay(opt_step))

    def run(self, images: torch.Tensor, targets: torch.Tensor):
        """One micro-step; returns the loss (detached; the global batch's, the mean of the
        ranks' losses, under a process group) and the fp32 outputs."""
        outputs = self.forward(images)
        loss, _ = self.loss(outputs, targets)
        self.backward(loss)
        self.update()
        loss = loss.detach()
        if self.ddp is not None:
            loss = global_sum(loss) / get_world_size()
        return loss, outputs


def _clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm``: ``g / norm * max_norm`` where the global norm is
    at least ``max_norm``, else unchanged (``clip_grad_norm_`` adds 1e-6 to the norm).
    Decided on the device, without a host sync."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))


class Trainer:
    """Counterpart of the JAX ``Trainer``: ``train``, ``evaluate`` and ``test``."""

    def __init__(self, experiment_name: str, ckpt_root_dir: Optional[str] = None):
        self.experiment_name = experiment_name
        self.ckpt_root_dir = ckpt_root_dir
        self.run_id = generate_run_id()
        self.ckpt_dir: Optional[str] = None
        self.best_metric: Optional[float] = None
        self.train_state: Optional[TrainState] = None
        self.train_loss_history: List[float] = []
        self.valid_metrics_history: List[Dict[str, float]] = []
        self.test_metrics_history: List[Dict[str, Dict[str, float]]] = []
        self.train_metrics_history: List[Dict[str, float]] = []
        self.unconsumed_training_params: List[str] = []
        self.sg_logger = None
        self._recipe_cfg: Optional[Dict] = None  # the whole recipe when launched by train_from_config

    def prepare(self, model, training_params: Dict, steps_per_epoch: int) -> TrainStep:
        """The :class:`TrainStep` that ``train()`` runs for these parameters, over a
        fresh copy of ``model.net`` in train mode (channels_last on a GPU under the bf16 policy,
        :func:`channels_last_training`)."""
        tp = training_params if isinstance(training_params, _TrackedParams) else self._tracked_params(training_params)
        max_epochs = int(tp["max_epochs"])
        batch_accumulate = int(tp.get("batch_accumulate") or 1)
        criterion = get_loss(tp.get("loss"), tp.get("criterion_params"))

        initial_lr, lr_group_dict = tp["initial_lr"], None
        if tp.get("finetune"):
            logger.warning("finetune=True has no effect: the model has no predefined fine-tune LR groups")
        if isinstance(initial_lr, dict):
            lr_group_dict = {k: float(v) for k, v in initial_lr.items()}
            initial_lr = lr_group_dict["default"] if "default" in lr_group_dict else next(iter(lr_group_dict.values()))
        lr_schedule = build_lr_schedule(
            lr_mode=tp.get("lr_mode"),
            initial_lr=float(initial_lr),
            max_epochs=max_epochs,
            steps_per_epoch=max(1, steps_per_epoch // batch_accumulate),
            lr_warmup_epochs=int(tp.get("lr_warmup_epochs") or 0),
            lr_warmup_steps=int(tp.get("lr_warmup_steps") or 0),
            warmup_initial_lr=tp.get("warmup_initial_lr"),
            lr_cooldown_epochs=int(tp.get("lr_cooldown_epochs") or 0),
            warmup_mode=tp.get("warmup_mode", "LinearEpochLRWarmup"),
            cosine_final_lr_ratio=float(tp.get("cosine_final_lr_ratio") or 0.01),
            lr_updates=tp.get("lr_updates") or [],
            lr_decay_factor=float(tp.get("lr_decay_factor") or 0.1),
            lr_schedule_function=tp.get("lr_schedule_function"),
            step_lr_update_freq=tp.get("step_lr_update_freq"),
        )

        net = copy.deepcopy(model.net).train()
        if channels_last_training(model.device, bool(tp.get("mixed_precision"))):
            net = net.to(memory_format=torch.channels_last)
        if is_distributed():
            convert_batch_norm(net)  # statistics over the global batch (one rank's batch is the global one)
        # frozen parameters get no update and no weight decay: they stay out of the optimizer
        frozen = list(tp.get("frozen_param_patterns") or [])
        if hasattr(net, "student") and hasattr(net, "teacher") and "teacher" not in frozen:
            frozen.append("teacher")
            logger.info("kd_module detected: freezing `teacher` subtree (no updates, no weight decay)")
        trainable = []
        for name, p in net.named_parameters():
            if any(pattern in name for pattern in frozen):
                p.requires_grad_(False)
            else:
                trainable.append((name, p))
        optimizer = build_optimizer(
            tp.get("optimizer", "SGD"), trainable, tp.get("optimizer_params"),
            zero_weight_decay_on_bias_and_bn=bool(tp.get("zero_weight_decay_on_bias_and_bn")),
            lr_group_dict=lr_group_dict,
        )

        ema_decay = None
        ema_cfg = dict(tp.get("ema_params") or {})
        if tp.get("ema"):
            ema_decay = make_decay_fn(
                decay=float(ema_cfg.get("decay", 0.9999)), decay_type=ema_cfg.get("decay_type", "exp"),
                beta=float(ema_cfg.get("beta", 15)),
                total_steps=max(1, max_epochs * steps_per_epoch // batch_accumulate),
            )
        state = TrainState(net=net, optimizer=optimizer, ema=ModelEMA(net) if ema_decay else None)
        ddp = None
        if process_group_active():
            # the global BN keeps the buffers equal on every rank: nothing to broadcast
            device_ids = [torch.cuda.current_device() if model.device.index is None else model.device.index] \
                if model.device.type == "cuda" else None
            ddp = torch.nn.parallel.DistributedDataParallel(net, device_ids=device_ids, broadcast_buffers=False)
        return TrainStep(state, criterion, lr_schedule, batch_accumulate, tp.get("clip_grad_norm"), ema_decay,
                         mixed_precision=bool(tp.get("mixed_precision")), ddp=ddp)

    @staticmethod
    def _tracked_params(training_params: Optional[Dict]) -> _TrackedParams:
        tp = _TrackedParams(copy.deepcopy(DEFAULT_TRAINING_PARAMS))
        tp.update(training_params or {})
        return tp

    # ------------------------------------------------------------------ train

    def train(self, model, training_params: Dict, train_loader, valid_loader=None,
              test_loaders: Optional[Dict[str, Any]] = None, additional_callbacks: Optional[Sequence[Callback]] = None):
        """Train ``model`` for ``max_epochs`` over ``train_loader`` (batches of
        ``(images [B, 3, H, W], targets [B, max_boxes, 5])``) and return it with the
        trained weights. Per-epoch mean losses go to ``train_loss_history``, the
        validation results (with the validation ``Loss``) to ``valid_metrics_history``."""
        tp = self._tracked_params(training_params)
        self.training_params = tp
        _refuse_unported(tp)
        # the dataset's class names and preprocessing go to the model, so that a trained model
        # predicts with them; as in the JAX trainer, a failure is logged at debug level only
        dataset = getattr(train_loader, "dataset", None)
        if hasattr(model, "set_dataset_processing_params") and hasattr(dataset, "get_dataset_preprocessing_params"):
            try:
                model.set_dataset_processing_params(**dataset.get_dataset_preprocessing_params())
            except Exception as e:
                logger.debug(f"preprocessing-params handoff skipped: {e}")
        if tp.get("cross_replica_bn"):
            logger.info("cross_replica_bn=True: BN already reduces over the global batch (no-op): "
                        + ("the ranks' BNs are global under DDP" if process_group_active() else "one device"))
        tp.get("seed")  # the YOLO-NAS train step draws no random numbers
        max_epochs = int(tp["max_epochs"])
        batch_accumulate = int(tp.get("batch_accumulate") or 1)

        step = self.prepare(model, tp, len(train_loader))
        state = step.state
        device = model.device

        # ---- resume (every rank loads; rank 0 names the run) ----------
        start_epoch = 0
        self.run_id = broadcast_from_primary(self.run_id)
        self.ckpt_dir = get_checkpoints_dir_path(self.experiment_name, self.ckpt_root_dir, self.run_id)
        if tp.get("resume") or tp.get("run_id") or tp.get("resume_path"):
            start_epoch = self._try_resume(tp, state)
        barrier()  # every rank has read the run before rank 0 writes into it
        primary = is_primary_process()
        if primary:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            self._persist_recipe(tp, model)
        barrier()

        train_metrics = MetricCollection([get_metric(m) for m in (tp.get("train_metrics_list") or [])])
        has_train_metrics = bool(train_metrics.metrics)
        valid_metrics = MetricCollection([get_metric(m) for m in (tp.get("valid_metrics_list") or [])])

        # ---- callbacks / context ----------------------------------------
        callbacks = [resolve_callback(c) for c in list(tp.get("phase_callbacks") or []) + list(additional_callbacks or [])]
        handler = CallbackHandler(callbacks)
        context = PhaseContext(trainer=self, model=model, training_params=tp, experiment_name=self.experiment_name,
                               ckpt_dir=self.ckpt_dir, train_loader=train_loader, valid_loader=valid_loader,
                               criterion=step.criterion)

        # cadence and naming knobs, read up front so that the silent-drop guard counts them
        run_test_freq = int(tp.get("run_test_freq") or 1)
        run_validation_freq = int(tp.get("run_validation_freq") or 1)
        tp.get("precise_bn_batch_size")  # acts through precise_bn only
        save_model = bool(tp.get("save_model", True))
        ckpt_name = tp.get("ckpt_name", "ckpt_latest")
        ckpt_best_name = tp.get("ckpt_best_name", "ckpt_best")
        save_ckpt_epoch_list = list(tp.get("save_ckpt_epoch_list") or [])
        tp.get("load_opt_params", True)  # acted on inside _try_resume
        metric_to_watch = tp.get("metric_to_watch", "Accuracy")
        best_tracker = ckpt_utils.BestCheckpointTracker(bool(tp.get("greater_metric_to_watch_is_better", True)))
        averager = (ckpt_utils.AverageBestModels(greater_is_better=best_tracker.greater_is_better)
                    if tp.get("average_best_models") and primary else None)
        silent = bool(tp.get("silent_mode")) or not primary

        # ---- experiment logger -----------------------------------------
        sg_logger_params = dict(tp.get("sg_logger_params") or {})
        sg_logger_params.setdefault("experiment_name", self.experiment_name)
        sg_logger_params.setdefault("checkpoints_dir_path", self.ckpt_dir)
        self.sg_logger = get_sg_logger(tp.get("sg_logger", "base_sg_logger"), **sg_logger_params)
        self.sg_logger.add_config("training_params", {k: v for k, v in tp.items() if not callable(v)})
        context.update_context(sg_logger=self.sg_logger)

        handler.on_training_start(context)
        max_train_batches = tp.get("max_train_batches")
        max_valid_batches = tp.get("max_valid_batches")
        # host-sync cadence: the running loss and LR reach the context every N batches only
        sync_every = int(tp.get("train_logging_frequency") or 50)
        eval_net = None  # built at the end of the first epoch
        train_max_value = dataloaders.loader_max_value(train_loader)

        try:
            for epoch in range(start_epoch, max_epochs):
                context.update_context(epoch=epoch)
                if context.stop_training:
                    break
                if hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch)
                handler.on_train_loader_start(context)
                # a stage-switch callback may have asked for another criterion
                if context._criterion_updates:
                    if not isinstance(tp.get("loss"), str):
                        logger.warning("criterion update requested but loss is an instance: ignored")
                    else:
                        new_cp = {**(tp.get("criterion_params") or {}), **context._criterion_updates}
                        tp["criterion_params"] = new_cp
                        step.criterion = get_loss(tp.get("loss"), new_cp)
                        context.update_context(criterion=step.criterion)
                        logger.info(f"Criterion rebuilt with {context._criterion_updates} (epoch {epoch})")
                    context._criterion_updates = {}
                t0 = time.time()
                loss_sum, loss_count, lr = 0.0, 0, None
                train_mstates = train_metrics.init()
                for batch_idx, batch in enumerate(train_loader):
                    if max_train_batches and batch_idx >= max_train_batches:
                        break
                    context.update_context(batch_idx=batch_idx, step=state.step, train_batch=batch)
                    handler.on_train_batch_start(context)
                    images, targets = _to_device(batch[0], batch[1], device, train_max_value,
                                                 channels_last_training(device, step.mixed_precision))
                    loss, outputs = step.run(images, targets)
                    lr = step.lr_schedule((state.step - 1) // batch_accumulate)
                    if has_train_metrics:
                        train_mstates = self._update_metrics(train_metrics, train_mstates, _metrics_view(outputs),
                                                             targets, batch[1])
                    del outputs
                    loss_sum = loss_sum + loss
                    loss_count += 1
                    context.step_metrics = {"loss": loss, "lr": lr}  # the loss a device scalar: float() syncs
                    if loss_count % sync_every == 0:
                        context.update_context(loss_avg=float(loss_sum) / loss_count, lr=lr)
                    handler.on_train_batch_end(context)
                epoch_time = time.time() - t0
                train_loss = float(loss_sum) / max(loss_count, 1)
                self.train_loss_history.append(train_loss)
                context.update_context(loss_avg=train_loss, lr=lr)
                context.metrics_dict.update({"train_loss": train_loss})
                train_results = train_metrics.compute(train_mstates) if has_train_metrics else {}
                if has_train_metrics:
                    self.train_metrics_history.append(train_results)
                context.metrics_dict.update({f"Train_{k}": v for k, v in train_results.items()})
                # the epoch's trained network, for the visualization callbacks, validation and tests
                eval_net = self._refresh_eval_net(eval_net, state)
                context.update_context(train_state=state, eval_net=eval_net)
                handler.on_train_loader_end(context)

                # ---------- validation ----------
                should_validate = valid_loader is not None and (
                    (epoch + 1) % run_validation_freq == 0 or epoch == max_epochs - 1)
                valid_results: Dict[str, float] = {}
                if should_validate:
                    handler.on_validation_loader_start(context)
                    valid_results = self._run_eval_loop(eval_net, step.criterion, valid_metrics, valid_loader, device,
                                                        step.mixed_precision, max_valid_batches, handler, context)
                    self.valid_metrics_history.append(valid_results)
                    context.update_context(valid_metrics=valid_results)
                    handler.on_validation_loader_end(context)

                # ---------- test loaders ----------
                test_results: Dict[str, Dict[str, float]] = {}
                should_test = test_loaders and ((epoch + 1) % run_test_freq == 0 or epoch == max_epochs - 1)
                if should_test:
                    for tname, tloader in test_loaders.items():
                        res = self._run_eval_loop(eval_net, step.criterion, valid_metrics, tloader, device,
                                                  step.mixed_precision, max_valid_batches, None, context)
                        test_results[tname] = res
                        context.metrics_dict.update({f"{tname}:{k}": v for k, v in res.items()})
                    self.test_metrics_history.append(test_results)
                    handler.on_test_loader_end(context)

                if not silent:
                    msg = f"Epoch {epoch + 1}/{max_epochs} | loss {train_loss:.4f} | {epoch_time:.1f}s"
                    if valid_results:
                        msg += " | " + " ".join(f"{k}={v:.4f}" for k, v in valid_results.items())
                    logger.info(msg)

                self.sg_logger.add_scalar("Train/loss", train_loss, epoch)
                for k, v in train_results.items():
                    self.sg_logger.add_scalar(f"Train/{k}", v, epoch)
                if lr is not None:
                    self.sg_logger.add_scalar("Train/lr", lr, epoch)
                self.sg_logger.add_scalar("Train/epoch_time_s", epoch_time, epoch)
                for k, v in valid_results.items():
                    self.sg_logger.add_scalar(f"Valid/{k}", v, epoch)
                for tname, res in test_results.items():
                    for k, v in res.items():
                        self.sg_logger.add_scalar(f"Test_{tname}/{k}", v, epoch)
                self.sg_logger.flush()

                # ---------- checkpoints (every rank tracks the best; rank 0 writes) ----------
                if save_model:
                    self._save_epoch_checkpoints(state, epoch, valid_results, metric_to_watch, best_tracker, averager,
                                                 ckpt_name, ckpt_best_name, save_ckpt_epoch_list, write=primary)
                    barrier()
        except KeyboardInterrupt:
            logger.info("Ctrl-C: training stops; the checkpoints written so far are kept")

        handler.on_training_end(context)
        self.sg_logger.close()

        self.unconsumed_training_params = tp.unread_keys()
        if self.unconsumed_training_params:
            logger.warning(f"training_params keys never consumed (silent-drop guard): {self.unconsumed_training_params}")

        state.net.eval()
        model.load_state_dict(self._eval_state_dict(state))
        self.train_state = state
        return model

    # ------------------------------------------------------------- eval loop

    @staticmethod
    def _update_metrics(metrics: MetricCollection, mstates, outputs, targets: torch.Tensor, host_targets):
        """Device metrics on the outputs; host metrics on their device reduction,
        which goes to the host once."""
        with torch.no_grad():
            mstates = metrics.update_device(mstates, outputs, targets)
            aux = metrics.preprocess_device(outputs, targets)
        if metrics.has_host_metrics():
            mstates = metrics.update_host(mstates, to_host(aux), to_host(host_targets))
        return mstates

    def _run_eval_loop(self, net, criterion, metrics: MetricCollection, loader, device, mixed_precision: bool,
                       max_batches, handler, context) -> Dict[str, float]:
        """One pass over ``loader``: forward in eval mode under the bf16 policy when
        ``mixed_precision``, outputs cast to fp32, metrics, and the mean ``Loss``
        when there is a criterion."""
        mstates = metrics.init()
        loss_sum, count = 0.0, 0
        for vidx, batch in enumerate(loader):
            if max_batches and vidx >= max_batches:
                break
            if context is not None:
                context.update_context(batch_idx=vidx, valid_batch=batch)
            images, targets = _to_device(batch[0], batch[1], device, dataloaders.loader_max_value(loader),
                                         channels_last_training(device, mixed_precision))
            with torch.inference_mode():
                with autocast(device, mixed_precision):
                    outputs = net(images)
                outputs = to_f32(outputs)
                if criterion is not None:
                    loss_sum = loss_sum + criterion(outputs, targets)[0]
                mstates = self._update_metrics(metrics, mstates, _metrics_view(outputs), targets, batch[1])
            count += 1
            if handler is not None:
                handler.on_validation_batch_end(context)
        if count == 0:
            logger.warning("eval loop: the data loader yielded 0 batches; metrics are empty")
        results = metrics.compute(mstates)
        if criterion is not None:
            if process_group_active():  # each rank's loss is its share of the global batch's
                loss_sum = float(global_sum(torch.as_tensor(loss_sum, dtype=torch.float64))) / get_world_size()
            results["Loss"] = float(loss_sum) / max(count, 1)
        return results

    @staticmethod
    def _eval_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
        return state.ema.state_dict() if state.ema is not None else state.net.state_dict()

    def _refresh_eval_net(self, eval_net, state: TrainState):
        """The network validation runs: a copy of the trained one in eval mode, with
        the EMA weights (or the live ones without EMA) loaded anew each time."""
        if eval_net is None:
            eval_net = copy.deepcopy(state.net)
            for p in eval_net.parameters():
                p.grad = None
                p.requires_grad_(False)
        eval_net.load_state_dict(self._eval_state_dict(state))
        return eval_net.eval()

    # ------------------------------------------------------------ checkpoints

    def _save_epoch_checkpoints(self, state: TrainState, epoch: int, valid_results: Dict[str, float], metric_to_watch,
                                best_tracker, averager, ckpt_name="ckpt_latest", ckpt_best_name="ckpt_best",
                                save_ckpt_epoch_list=(), write: bool = True):
        """Track the best ``metric_to_watch``; with ``write``, write the epoch's checkpoints."""
        payload = None
        if write:
            payload = ckpt_utils.serialize({
                **state.state_dict(),
                "epoch": epoch,
                "metrics": {k: float(v) for k, v in valid_results.items()},
                "experiment": self.experiment_name,
                "ckpt_version": ckpt_utils.CKPT_VERSION,
            })
            ckpt_utils.save_checkpoint(self.ckpt_dir, ckpt_name, payload)
            if epoch in (save_ckpt_epoch_list or ()):
                ckpt_utils.save_checkpoint(self.ckpt_dir, f"ckpt_epoch_{epoch}", payload)

        watched = valid_results.get(metric_to_watch)
        if watched is not None:
            if averager is not None:
                weights = self._eval_state_dict(state)
                averager.update(watched, {name: weights[name] for name, _ in state.net.named_parameters()})
            if best_tracker.is_improvement(watched):
                self.best_metric = watched
                if write:
                    ckpt_utils.save_checkpoint(self.ckpt_dir, ckpt_best_name, payload)
                    logger.info(f"New best {metric_to_watch}={watched:.4f} -> {ckpt_best_name}")
        if averager is not None and averager.snapshots:
            # the averaged parameters with the LIVE BN statistics, as the JAX trainer pairs them
            net = {k: v.detach().cpu() for k, v in state.net.state_dict().items()}
            net.update(averager.averaged_params())
            ckpt_utils.save_checkpoint(self.ckpt_dir, "average_model", ckpt_utils.serialize({"net": net}))

    def _try_resume(self, tp, state: TrainState) -> int:
        """Restore ``state`` from the run's checkpoint; returns the epoch to start at."""
        resume_path = tp.get("resume_path")
        if resume_path:
            ckpt_dir, name = os.path.split(os.path.abspath(resume_path))
        else:
            run_id = tp.get("run_id") or get_latest_run_id(self.experiment_name, self.ckpt_root_dir)
            if run_id is None:
                logger.warning("resume=True but no previous run found: starting fresh")
                return 0
            self.run_id = run_id  # continue in the same run directory
            self.ckpt_dir = get_checkpoints_dir_path(self.experiment_name, self.ckpt_root_dir, run_id)
            ckpt_dir, name = self.ckpt_dir, tp.get("ckpt_name", "ckpt_latest")
        if not ckpt_utils.checkpoint_exists(ckpt_dir, name):
            logger.warning(f"resume checkpoint {ckpt_utils.checkpoint_path(ckpt_dir, name)} missing: starting fresh")
            return 0
        # on the CPU: load_state_dict copies the tensors to their device, and the optimizer
        # keeps its step counters on the CPU, as a fresh one does
        ckpt = ckpt_utils.load_checkpoint(ckpt_dir, name, map_location="cpu")
        has_opt = int(ckpt.get("ckpt_version", 1)) >= 2 and ckpt.get("optimizer_state_dict") is not None
        restore_opt = has_opt and bool(tp.get("load_opt_params", True))
        state.load_state_dict(ckpt, load_optimizer=restore_opt)
        if not restore_opt:
            if not tp.get("load_opt_params", True):
                logger.info("load_opt_params=False: momentum and moments start fresh")
            else:
                logger.warning("the checkpoint has no optimizer state: momentum and moments start fresh")
        start_epoch = int(ckpt.get("epoch", -1)) + 1
        logger.info(f"Resumed from {ckpt_utils.checkpoint_path(ckpt_dir, name)} at epoch {start_epoch}")
        return start_epoch

    def _persist_recipe(self, tp: Dict, model) -> None:
        """Write the resolved training parameters next to the checkpoints (``recipe.json``)."""

        def _clean(obj):
            if isinstance(obj, dict):
                return {k: _clean(v) for k, v in obj.items() if not callable(v)}
            if isinstance(obj, (list, tuple)):
                return [_clean(v) for v in obj if not callable(v)]
            if isinstance(obj, (str, int, float, bool)) or obj is None:
                return obj
            return repr(obj)

        recipe = self._recipe_cfg if self._recipe_cfg is not None else {
            "experiment_name": self.experiment_name,
            "architecture": getattr(model, "name", None),
            "num_classes": getattr(model, "num_classes", None),
            "training_hyperparams": tp,
        }
        try:
            with open(os.path.join(self.ckpt_dir, "recipe.json"), "w") as f:
                json.dump(_clean(recipe), f, indent=2)
        except Exception as e:  # never fail training over recipe serialization
            logger.warning(f"Could not persist recipe.json: {e}")

    # ------------------------------------------------------------- evaluation

    def evaluate(self, model, data_loader, training_params: Optional[Dict] = None, metrics_list=None) -> Dict[str, float]:
        """One pass of ``model.net`` (its own weights, eval mode, fp32) over
        ``data_loader``: the metrics of ``metrics_list`` (or of the parameters'
        ``valid_metrics_list``), and ``Loss`` when the parameters name a loss."""
        tp = copy.deepcopy(DEFAULT_TRAINING_PARAMS)
        tp.update(training_params or {})
        metrics = MetricCollection([get_metric(m) for m in (metrics_list or tp.get("valid_metrics_list") or [])])
        criterion = get_loss(tp.get("loss"), tp.get("criterion_params")) if tp.get("loss") else None
        return self._run_eval_loop(model.net.eval(), criterion, metrics, data_loader, model.device, False, None, None, None)

    def test(self, model, test_loader, test_metrics_list=None, loss=None) -> Dict[str, float]:
        return self.evaluate(model, test_loader, {"loss": loss} if loss else {}, metrics_list=test_metrics_list)

    # ------------------------------------------------------------ recipes

    @staticmethod
    def _trigger_cfg_modifying_callbacks(cfg: Dict) -> Dict:
        """Run the recipe's ``pre_launch_callbacks_list`` over it before anything is built:
        each entry a name, ``{name: params}`` or a callable, as the JAX trainer resolves them."""
        for entry in cfg.get("pre_launch_callbacks_list") or []:
            cfg = resolve_pre_launch_callback(entry)(cfg) or cfg
        return cfg

    @staticmethod
    def _model_from_cfg(cfg: Dict):
        """``models.get`` with the recipe's ``checkpoint_params`` (``checkpoint_path``,
        ``pretrained_weights``, ``checkpoint_num_classes``, ``load_backbone``,
        ``strict_load``), on the recipe's ``device`` (the GPU unless it says ``cpu``). A
        ``kd_module``'s teacher loads ``teacher_pretrained_weights`` (the local mirror, as
        ``pretrained_weights``) or ``teacher_checkpoint_path``; a model without a teacher
        ignores them, as in the JAX trainer."""
        from super_gradients_tpu_torch import models

        cp = cfg.get("checkpoint_params") or {}
        model = models.get(
            cfg["architecture"],
            num_classes=cfg.get("num_classes") or (cfg.get("arch_params") or {}).get("num_classes"),
            arch_params=cfg.get("arch_params"),
            checkpoint_path=cp.get("checkpoint_path"),
            pretrained_weights=cp.get("pretrained_weights"),
            checkpoint_num_classes=cp.get("checkpoint_num_classes"),
            load_backbone=bool(cp.get("load_backbone")),
            strict_load=cp.get("strict_load"),
            device=cfg.get("device") or "cuda",
        )
        teacher_src = cp.get("teacher_pretrained_weights") or cp.get("teacher_checkpoint_path")
        if teacher_src and hasattr(model.net, "teacher"):
            ap = cfg.get("arch_params") or {}
            teacher_name = ap.get("teacher") or ap.get("teacher_architecture")
            if teacher_name is None:
                raise ValueError("teacher_pretrained_weights set but arch_params has no teacher name")
            teacher = models.get(
                teacher_name,
                num_classes=cfg.get("num_classes") or ap.get("num_classes"),
                arch_params=ap.get("teacher_arch_params"),
                pretrained_weights=cp.get("teacher_pretrained_weights"),
                checkpoint_path=cp.get("teacher_checkpoint_path"),
                device=model.device,
            )
            state = model.net.state_dict()
            state.update({f"teacher.{k}": v for k, v in teacher.net.state_dict().items()})
            model.load_state_dict(state)
            logger.info(f"kd_module teacher `{teacher_name}` loaded from {teacher_src}")
        return model

    @staticmethod
    def _loader_from_cfg(cfg: Dict, split: str):
        params = cfg.get("dataset_params") or {}
        return dataloaders.get(
            cfg.get(f"{split}_dataloader"),
            dataset_params=params.get(f"{split}_dataset_params"),
            dataloader_params=params.get(f"{split}_dataloader_params"),
        )

    @classmethod
    def train_from_config(cls, cfg: Dict):
        """Train from a resolved recipe: its model, its train and val loaders, its
        ``training_hyperparams``; ``recipe.json`` holds the whole recipe. Returns
        ``(model, trainer)``."""
        cfg = cls._trigger_cfg_modifying_callbacks(dict(cfg))
        trainer = cls(experiment_name=cfg.get("experiment_name", "experiment"), ckpt_root_dir=cfg.get("ckpt_root_dir"))
        trainer._recipe_cfg = cfg
        model = cls._model_from_cfg(cfg)
        train_loader = cls._loader_from_cfg(cfg, "train")
        valid_loader = cls._loader_from_cfg(cfg, "val")
        model = trainer.train(model, cfg.get("training_hyperparams") or {}, train_loader, valid_loader)
        return model, trainer

    @staticmethod
    def _load_run_recipe(experiment_name: str, ckpt_root_dir: Optional[str], run_id: Optional[str]):
        run_id = run_id or get_latest_run_id(experiment_name, ckpt_root_dir)
        if run_id is None:
            raise FileNotFoundError(f"No previous run found for experiment `{experiment_name}`")
        ckpt_dir = get_checkpoints_dir_path(experiment_name, ckpt_root_dir, run_id)
        recipe_path = os.path.join(ckpt_dir, "recipe.json")
        if not os.path.exists(recipe_path):
            raise FileNotFoundError(f"{recipe_path} missing: the run was not launched from a recipe")
        with open(recipe_path) as f:
            return run_id, ckpt_dir, json.load(f)

    @classmethod
    def evaluate_checkpoint(cls, experiment_name: str, ckpt_root_dir: Optional[str] = None,
                            ckpt_name: str = "ckpt_best", run_id: Optional[str] = None) -> Dict[str, float]:
        """Rebuild a recipe-launched run's model and val loader from its ``recipe.json``,
        load the named checkpoint (its EMA weights when it has them) and validate, on the
        device the recipe names (the GPU where it names none)."""
        from super_gradients_tpu_torch.parallel import mesh

        _, ckpt_dir, cfg = cls._load_run_recipe(experiment_name, ckpt_root_dir, run_id)
        mesh.setup_device(device=cfg.get("device") or "cuda")
        model = cls._model_from_cfg(cfg)
        ckpt_utils.load_checkpoint_into_model(model, ckpt_utils.checkpoint_path(ckpt_dir, ckpt_name))
        valid_loader = cls._loader_from_cfg(cfg, "val")
        trainer = cls(experiment_name, ckpt_root_dir=ckpt_root_dir)
        return trainer.evaluate(model, valid_loader, cfg.get("training_hyperparams") or {})

    @classmethod
    def resume_experiment(cls, experiment_name: str, ckpt_root_dir: Optional[str] = None, run_id: Optional[str] = None):
        """Continue a recipe-launched run from its ``recipe.json`` and latest checkpoint, on
        the device the recipe names (the GPU where it names none)."""
        from super_gradients_tpu_torch.parallel import mesh

        run_id, _, cfg = cls._load_run_recipe(experiment_name, ckpt_root_dir, run_id)
        if "architecture" not in cfg or cfg.get("train_dataloader") is None and "dataset_params" not in cfg:
            raise ValueError(
                "Persisted recipe lacks model/dataloader config (the run was launched via "
                "Trainer.train() directly); resume by calling train() again with "
                "training_params={'resume': True, 'run_id': run_id}"
            )
        mesh.setup_device(device=cfg.get("device") or "cuda")
        cfg.setdefault("training_hyperparams", {})
        cfg["training_hyperparams"]["resume"] = True
        cfg["training_hyperparams"]["run_id"] = run_id
        if ckpt_root_dir:
            cfg["ckpt_root_dir"] = ckpt_root_dir
        return cls.train_from_config(cfg)
