"""Trainer.train (counterpart of the ``train()`` core of
``super_gradients_tpu/training/trainer.py``).

``Trainer(...).train(model, training_params, train_loader)`` trains a copy of
``model.net`` on the model's device (the GPU unless the caller passes a CPU
model) and hands the EMA weights (or the live ones without EMA) back through
``model.load_state_dict``. Each batch is one micro-step of :class:`TrainStep`:
forward under the bf16 policy, PPYoloELoss (or any registered loss) in fp32,
backward; every ``batch_accumulate`` micro-steps the mean gradient is clipped,
the LR set from the schedule and the optimizer and EMA stepped, as optax
``MultiSteps`` does.

Validation, test loaders, metrics, callbacks, loggers, checkpoints, resume,
precise BN, QAT and KD are not ported yet: a training parameter or argument that
asks for one of them raises ``NotImplementedError`` naming its ROADMAP item.
Since ``save_model`` defaults to True, callers pass ``save_model=False``.
"""

from __future__ import annotations

import copy
import logging
from typing import Callable, Dict, List, Optional

import torch

from super_gradients_tpu_torch.training.ema import ModelEMA, make_decay_fn
from super_gradients_tpu_torch.training.losses import get_loss
from super_gradients_tpu_torch.training.mixed_precision import autocast, to_f32
from super_gradients_tpu_torch.training.optimizers import build_optimizer
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

_VALIDATION = "ROADMAP.md queue 1, 'Validation with DetectionMetrics'"
_CHECKPOINTS = "ROADMAP.md queue 1, 'Checkpoints and resume'"
_LATER = "ROADMAP.md queue 1, 'Breadth' and 'Deployment and scale-out'"

# settings that only act through a feature not ported yet; read so that the
# silent-drop guard counts them, and inert while that feature is off
_INERT_UNTIL_PORTED = (
    "ckpt_name", "ckpt_best_name", "save_ckpt_epoch_list", "load_opt_params", "average_best_models",
    "metric_to_watch", "greater_metric_to_watch_is_better", "run_validation_freq", "run_test_freq",
    "max_valid_batches", "precise_bn_batch_size", "sg_logger_params",
)


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


def _refuse_unported(tp: _TrackedParams, valid_loader, test_loaders, additional_callbacks) -> None:
    asks = [
        ("valid_loader", valid_loader is not None, _VALIDATION),
        ("test_loaders", bool(test_loaders), _VALIDATION),
        ("additional_callbacks", bool(additional_callbacks), _VALIDATION),
        ("valid_metrics_list", bool(tp.get("valid_metrics_list")), _VALIDATION),
        ("train_metrics_list", bool(tp.get("train_metrics_list")), _VALIDATION),
        ("phase_callbacks", bool(tp.get("phase_callbacks")), _VALIDATION),
        ("sg_logger", tp.get("sg_logger") not in (None, "base_sg_logger"), _VALIDATION),
        ("save_model", bool(tp.get("save_model")), _CHECKPOINTS),
        ("resume", bool(tp.get("resume")), _CHECKPOINTS),
        ("run_id", tp.get("run_id") is not None, _CHECKPOINTS),
        ("resume_path", tp.get("resume_path") is not None, _CHECKPOINTS),
        ("precise_bn", bool(tp.get("precise_bn")), _LATER),
        ("qat_params", bool((tp.get("qat_params") or {}).get("enabled")), _LATER),
    ]
    for name, asked, item in asks:
        if asked:
            raise NotImplementedError(
                f"Trainer.train: `{name}` asks for a feature that super_gradients_tpu_torch does not have yet ({item})"
                + ("; pass save_model=False" if name == "save_model" else "")
            )
    for key in _INERT_UNTIL_PORTED:
        tp.get(key)


class TrainStep:
    """One micro-step of the train loop, in the four parts ``chip_smoke.py`` times:
    :meth:`forward`, :meth:`loss`, :meth:`backward` and :meth:`update`."""

    def __init__(self, state: TrainState, criterion: Callable, lr_schedule: Callable[[float], float],
                 batch_accumulate: int = 1, clip_grad_norm: Optional[float] = None,
                 ema_decay: Optional[Callable[[float], float]] = None, mixed_precision: bool = False):
        self.state = state
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
        with autocast(self.device, self.mixed_precision):
            out = self.state.net(images)
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

    def __call__(self, images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        loss, _ = self.loss(self.forward(images), targets)
        self.backward(loss)
        self.update()
        return loss.detach()


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
    """Counterpart of the JAX ``Trainer`` (``train()`` only so far)."""

    def __init__(self, experiment_name: str, ckpt_root_dir: Optional[str] = None):
        self.experiment_name = experiment_name
        self.ckpt_root_dir = ckpt_root_dir  # read once checkpoints are ported
        self.train_state: Optional[TrainState] = None
        self.train_loss_history: List[float] = []
        self.unconsumed_training_params: List[str] = []

    def prepare(self, model, training_params: Dict, steps_per_epoch: int) -> TrainStep:
        """The :class:`TrainStep` that ``train()`` runs for these parameters, over a
        fresh copy of ``model.net`` in train mode (channels_last on a GPU)."""
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
        if model.device.type == "cuda":
            net = net.to(memory_format=torch.channels_last)
        # frozen parameters get no update and no weight decay: they stay out of the optimizer
        frozen = list(tp.get("frozen_param_patterns") or [])
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
        return TrainStep(state, criterion, lr_schedule, batch_accumulate, tp.get("clip_grad_norm"), ema_decay,
                         mixed_precision=bool(tp.get("mixed_precision")))

    @staticmethod
    def _tracked_params(training_params: Optional[Dict]) -> _TrackedParams:
        tp = _TrackedParams(copy.deepcopy(DEFAULT_TRAINING_PARAMS))
        tp.update(training_params or {})
        return tp

    def train(self, model, training_params: Dict, train_loader, valid_loader=None, test_loaders=None,
              additional_callbacks=None):
        """Train ``model`` for ``max_epochs`` over ``train_loader`` (batches of
        ``(images [B, 3, H, W], targets [B, max_boxes, 5])``) and return it with the
        trained weights; per-epoch mean losses go to ``train_loss_history``."""
        tp = self._tracked_params(training_params)
        _refuse_unported(tp, valid_loader, test_loaders, additional_callbacks)
        if tp.get("cross_replica_bn"):
            logger.info("cross_replica_bn=True: one device, BN already reduces over the whole batch (no-op)")
        tp.get("seed")  # the YOLO-NAS train step draws no random numbers
        silent = bool(tp.get("silent_mode"))
        max_epochs = int(tp["max_epochs"])
        max_train_batches = tp.get("max_train_batches")

        step = self.prepare(model, tp, len(train_loader))
        device = model.device
        for epoch in range(max_epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            loss_sum, count = 0.0, 0
            for batch_idx, (images, targets) in enumerate(train_loader):
                if max_train_batches and batch_idx >= max_train_batches:
                    break
                images = images.to(device, non_blocking=True)
                if device.type == "cuda":
                    images = images.contiguous(memory_format=torch.channels_last)
                loss_sum = loss_sum + step(images, targets.to(device, non_blocking=True))
                count += 1
            self.train_loss_history.append(float(loss_sum) / max(count, 1))
            if not silent:
                logger.info(f"Epoch {epoch + 1}/{max_epochs} | loss {self.train_loss_history[-1]:.4f}")

        self.unconsumed_training_params = tp.unread_keys()
        if self.unconsumed_training_params:
            logger.warning(f"training_params keys never consumed (silent-drop guard): {self.unconsumed_training_params}")

        state = step.state
        state.net.eval()
        model.load_state_dict(state.ema.state_dict() if state.ema is not None else state.net.state_dict())
        self.train_state = state
        return model
