"""Phase callbacks (counterpart of ``super_gradients_tpu/training/callbacks.py``).

``Trainer.train`` calls a :class:`CallbackHandler`'s ``on_*`` events at the same
points of its loop as the JAX trainer, with one mutable :class:`PhaseContext`.
Ported: the event protocol, ``EarlyStop``, ``TimerCallback``, ``LRCallbackBase``,
``ProfilerCallback`` (on ``torch.profiler``), ``PPYoloETrainingStageSwitchCallback``
and the detection visualization callbacks, which draw a batch's predictions
(``inference/prediction_results.py``) into the logger's ``add_image``. Names the JAX
package registers beyond these are listed in :data:`NOT_PORTED` with their ROADMAP
item; resolving one raises ``KeyError``.
"""

from __future__ import annotations

import enum
import logging
import math
import os
import time
from typing import Any, Dict, Optional, Sequence

from super_gradients_tpu_torch.common.factories import BaseFactory
from super_gradients_tpu_torch.common.registry import CALLBACKS, register_callback
from super_gradients_tpu_torch.inference.prediction_results import DetectionPrediction
from super_gradients_tpu_torch.ops.nms import NMSOutput, batched_nms
from super_gradients_tpu_torch.training.dataloaders import loader_max_value

logger = logging.getLogger(__name__)

_SEGMENTATION = "ROADMAP.md queue 1, 'Breadth' (segmentation)"
NOT_PORTED = {
    **dict.fromkeys(("SegmentationVisualizationCallback", "ExtremeBatchSegVisualizationCallback"), _SEGMENTATION),
    "ModelConversionCheckCallback": "ROADMAP.md queue 1, 'Deployment and scale-out' (export)",
    "SlidingWindowValidationCallback": _SEGMENTATION,
    "YoloXTrainingStageSwitchCallback": "ROADMAP.md queue 1, 'Breadth' (YOLOX loss)",
}


class Phase(str, enum.Enum):
    PRE_TRAINING = "PRE_TRAINING"
    TRAIN_EPOCH_START = "TRAIN_EPOCH_START"
    TRAIN_BATCH_START = "TRAIN_BATCH_START"
    TRAIN_BATCH_END = "TRAIN_BATCH_END"
    TRAIN_EPOCH_END = "TRAIN_EPOCH_END"
    VALIDATION_EPOCH_START = "VALIDATION_EPOCH_START"
    VALIDATION_BATCH_END = "VALIDATION_BATCH_END"
    VALIDATION_EPOCH_END = "VALIDATION_EPOCH_END"
    TEST_EPOCH_END = "TEST_EPOCH_END"
    POST_TRAINING = "POST_TRAINING"


class PhaseContext:
    """Mutable blackboard handed to every callback."""

    def __init__(self, **kwargs):
        self.epoch: int = 0
        self.batch_idx: int = 0
        self.step: int = 0
        self.metrics_dict: Dict[str, float] = {}
        self.loss_avg: Optional[float] = None
        self.lr: Optional[float] = None
        self.train_state = None
        self.trainer = None
        self.model = None
        self.stop_training: bool = False
        self.training_params: Dict = {}
        self.experiment_name: str = ""
        self.ckpt_dir: Optional[str] = None
        self.valid_metrics: Dict[str, float] = {}
        self.train_loader = None
        self.valid_loader = None
        self.sg_logger = None
        self.valid_batch = None  # host-side (inputs, targets) of the current val batch
        self.train_batch = None  # host-side (inputs, targets) of the current train batch
        self.step_metrics = None  # {"loss", "lr"} of the last train step; the loss a device tensor
        self.criterion = None  # the loss the train step runs (rebuilt by a stage switch)
        self.eval_net = None  # the trained weights (the EMA's when there is one) in eval mode, from each epoch's end
        self._criterion_updates: Dict[str, Any] = {}
        self.__dict__.update(kwargs)

    def update_context(self, **kwargs):
        self.__dict__.update(kwargs)

    def update_criterion_params(self, **kwargs):
        """Request a loss rebuild with changed criterion_params, applied by the
        Trainer right after this epoch's ``on_train_loader_start``."""
        self._criterion_updates.update(kwargs)


class Callback:
    """Subscribe to phase events."""

    def on_training_start(self, context: PhaseContext):
        pass

    def on_train_loader_start(self, context: PhaseContext):
        pass

    def on_train_batch_start(self, context: PhaseContext):
        pass

    def on_train_batch_end(self, context: PhaseContext):
        pass

    def on_train_loader_end(self, context: PhaseContext):
        pass

    def on_validation_loader_start(self, context: PhaseContext):
        pass

    def on_validation_batch_end(self, context: PhaseContext):
        pass

    def on_validation_loader_end(self, context: PhaseContext):
        pass

    def on_test_loader_end(self, context: PhaseContext):
        pass

    def on_training_end(self, context: PhaseContext):
        pass


class PhaseCallback(Callback):
    """Single-phase callback: ``__call__`` runs at the event of its ``phase``."""

    def __init__(self, phase: Phase):
        self.phase = phase

    def __call__(self, context: PhaseContext):
        pass

    _PHASE_TO_EVENT = {
        Phase.PRE_TRAINING: "on_training_start",
        Phase.TRAIN_EPOCH_START: "on_train_loader_start",
        Phase.TRAIN_BATCH_START: "on_train_batch_start",
        Phase.TRAIN_BATCH_END: "on_train_batch_end",
        Phase.TRAIN_EPOCH_END: "on_train_loader_end",
        Phase.VALIDATION_EPOCH_START: "on_validation_loader_start",
        Phase.VALIDATION_BATCH_END: "on_validation_batch_end",
        Phase.VALIDATION_EPOCH_END: "on_validation_loader_end",
        Phase.TEST_EPOCH_END: "on_test_loader_end",
        Phase.POST_TRAINING: "on_training_end",
    }

    def __getattribute__(self, name):
        if name.startswith("on_"):
            phase = object.__getattribute__(self, "phase")
            if name == PhaseCallback._PHASE_TO_EVENT.get(phase):
                return object.__getattribute__(self, "__call__")
        return object.__getattribute__(self, name)


class CallbackHandler(Callback):
    """Fan-out to a list of callbacks, in order."""

    def __init__(self, callbacks: Sequence[Callback]):
        self.callbacks = list(callbacks)

    def _fan(self, event: str, context: PhaseContext):
        for cb in self.callbacks:
            getattr(cb, event)(context)

    def on_training_start(self, c):
        self._fan("on_training_start", c)

    def on_train_loader_start(self, c):
        self._fan("on_train_loader_start", c)

    def on_train_batch_start(self, c):
        self._fan("on_train_batch_start", c)

    def on_train_batch_end(self, c):
        self._fan("on_train_batch_end", c)

    def on_train_loader_end(self, c):
        self._fan("on_train_loader_end", c)

    def on_validation_loader_start(self, c):
        self._fan("on_validation_loader_start", c)

    def on_validation_batch_end(self, c):
        self._fan("on_validation_batch_end", c)

    def on_validation_loader_end(self, c):
        self._fan("on_validation_loader_end", c)

    def on_test_loader_end(self, c):
        self._fan("on_test_loader_end", c)

    def on_training_end(self, c):
        self._fan("on_training_end", c)


def resolve_callback(c) -> Callback:
    """A Callback instance as is, or one built from a registry name or a ``{name: params}`` dict."""
    if not (isinstance(c, (Callback, str)) or (isinstance(c, dict) and len(c) == 1)):
        raise TypeError(f"Cannot resolve phase callback from {c!r}")
    return BaseFactory(CALLBACKS, NOT_PORTED, kind="callback", unknown_error=KeyError).get(c)


@register_callback("EarlyStop")
class EarlyStop(Callback):
    """Stop when a watched validation metric stops improving."""

    def __init__(self, phase: str = "VALIDATION_EPOCH_END", monitor: str = "Accuracy", mode: str = "max",
                 patience: int = 3, min_delta: float = 0.0, check_finite: bool = True, verbose: bool = False):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.check_finite = check_finite
        self.verbose = verbose
        self.best: Optional[float] = None
        self.count = 0

    def on_validation_loader_end(self, context: PhaseContext):
        value = context.valid_metrics.get(self.monitor)
        if value is None:
            return
        if self.check_finite and not math.isfinite(value):
            context.stop_training = True
            return
        improved = self.best is None or (
            value > self.best + self.min_delta if self.mode == "max" else value < self.best - self.min_delta
        )
        if improved:
            self.best = value
            self.count = 0
        else:
            self.count += 1
            if self.count >= self.patience:
                if self.verbose:
                    logger.info(f"EarlyStop: `{self.monitor}` did not improve for {self.patience} epochs")
                context.stop_training = True


@register_callback("TimerCallback")
class TimerCallback(Callback):
    """Epoch wall time (host clock) into ``metrics_dict["epoch_time_s"]``."""

    def on_train_loader_start(self, context: PhaseContext):
        self._t0 = time.time()

    def on_train_loader_end(self, context: PhaseContext):
        context.metrics_dict["epoch_time_s"] = time.time() - self._t0


@register_callback("ProfilerCallback")
class ProfilerCallback(Callback):
    """A ``torch.profiler`` trace of a window of train steps.

    Starts at the ``start_step``-th train batch of epoch ``profile_epoch``, stops
    after ``num_steps`` more (or at the epoch's end) and writes a Chrome trace,
    ``trace_epoch<E>.json``, into ``logdir``. Device activity is recorded when
    CUDA is available.
    """

    def __init__(self, logdir: str = "profile", profile_epoch: int = 1, start_step: int = 5, num_steps: int = 5):
        self.logdir = logdir
        self.profile_epoch = profile_epoch
        self.start_step = start_step
        self.num_steps = num_steps
        self._batch = 0
        self._profiler = None

    def on_train_loader_start(self, context: PhaseContext):
        self._batch = 0

    def on_train_batch_end(self, context: PhaseContext):
        if context.epoch != self.profile_epoch:
            return
        self._batch += 1
        if self._batch == self.start_step and self._profiler is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self._profiler = profile(activities=activities)
            self._profiler.start()
            logger.info(f"ProfilerCallback: tracing {self.num_steps} steps -> {self.logdir}")
        elif self._profiler is not None and self._batch >= self.start_step + self.num_steps:
            self._stop(context.epoch)

    def on_train_loader_end(self, context: PhaseContext):
        if self._profiler is not None:  # loader shorter than the window
            self._stop(context.epoch)

    def _stop(self, epoch: int):
        self._profiler.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(self.logdir, f"trace_epoch{epoch}.json"))
        self._profiler = None


@register_callback("LRCallbackBase")
class LRLoggingCallback(Callback):
    def on_train_batch_end(self, context: PhaseContext):
        if context.lr is not None:
            context.metrics_dict["lr"] = context.lr


@register_callback("PPYoloETrainingStageSwitchCallback")
class PPYoloETrainingStageSwitchCallback(Callback):
    """Switch PPYoloELoss from the static ATSS assigner to TAL at
    ``static_assigner_end_epoch``: the Trainer rebuilds its criterion through
    ``get_loss`` with ``use_static_assigner=False``."""

    def __init__(self, static_assigner_end_epoch: int = 150):
        self.static_assigner_end_epoch = static_assigner_end_epoch
        self._done = False

    def on_train_loader_start(self, context: PhaseContext):
        if not self._done and context.epoch >= self.static_assigner_end_epoch:
            context.update_criterion_params(use_static_assigner=False)
            logger.info(f"PPYoloE stage switch at epoch {context.epoch}: static assigner -> TAL")
            self._done = True


# ---------------------------------------------------------------- visualization


def detect_for_visualization(net, images, max_value: Optional[float], conf: float):
    """A host batch ``[B, 3, H, W]`` (uint8 or standardized float) through ``net`` in eval
    mode on its device, as the trainer feeds it, then exact NMS (K1 on a GPU) with the JAX
    callbacks' settings (IoU 0.7, 256 candidates, 100 detections). Returns the
    standardized images ``[B, H, W, 3]`` on the host and the :class:`NMSOutput`."""
    import torch

    from super_gradients_tpu_torch.training.trainer import _images_to_device

    x = _images_to_device(images, next(net.parameters()).device, max_value)
    with torch.inference_mode():
        out = net(x)
        nms = batched_nms(out.pred_bboxes.float(), out.pred_scores.float(), score_threshold=conf, iou_threshold=0.7,
                          nms_top_k=256, max_predictions=100, mode="exact")
    return x.permute(0, 2, 3, 1).float().cpu().numpy(), NMSOutput(*(t.cpu() for t in nms))


def draw_detections(model, images, nms: NMSOutput):
    """Each image's drawn :class:`DetectionPrediction` (the image scaled to uint8 as the
    JAX callbacks scale it)."""
    import numpy as np

    drawn = []
    for j in range(images.shape[0]):
        n = int(nms.num_detections[j])
        img = images[j]
        img_u8 = np.clip(img * 255.0 if img.max() <= 1.5 else img, 0, 255).astype(np.uint8)
        pred = DetectionPrediction(bboxes_xyxy=nms.boxes[j, :n].numpy(), confidence=nms.scores[j, :n].numpy(),
                                   labels=nms.labels[j, :n].numpy(), class_names=getattr(model, "_class_names", None),
                                   image=img_u8)
        drawn.append(pred.draw())
    return drawn


@register_callback("DetectionVisualizationCallback")
class DetectionVisualizationCallback(Callback):
    """Draw the predictions of the trained network on the ``batch_idx``-th validation
    batch every ``freq`` epochs, up to ``max_images``, into the logger's ``add_image``."""

    def __init__(self, freq: int = 1, batch_idx: int = 0, max_images: int = 4, conf: float = 0.25):
        self.freq = freq
        self.batch_idx = batch_idx
        self.max_images = max_images
        self.conf = conf

    def on_validation_batch_end(self, context: PhaseContext):
        if context.epoch % self.freq != 0 or context.batch_idx != self.batch_idx or context.valid_batch is None:
            return
        model = context.model
        if getattr(model, "task", None) != "detection":
            return
        images, nms = detect_for_visualization(context.eval_net, context.valid_batch[0][: self.max_images],
                                               loader_max_value(context.valid_loader), self.conf)
        for j, drawn in enumerate(draw_detections(model, images, nms)):
            if context.sg_logger is not None:
                context.sg_logger.add_image(f"valid_detections/img{j}", drawn, context.epoch)


class ExtremeBatchCaseVisualizationCallback(Callback):
    """Keep the train batch of the largest (``max_``) or smallest loss of an epoch and
    visualize it at the epoch's end. Reading each step's loss syncs with the device once
    a step: the price of the feature."""

    def __init__(self, max_: bool = True, freq: int = 1, max_images: int = 4):
        self.max_ = max_
        self.freq = freq
        self.max_images = max_images
        self._extreme_loss = None
        self._extreme_batch = None

    def on_train_loader_start(self, context: PhaseContext):
        self._extreme_loss, self._extreme_batch = None, None

    def on_train_batch_end(self, context: PhaseContext):
        if context.epoch % self.freq != 0 or context.step_metrics is None or context.train_batch is None:
            return
        loss = float(context.step_metrics["loss"])
        if self._extreme_loss is None or (loss > self._extreme_loss if self.max_ else loss < self._extreme_loss):
            self._extreme_loss = loss
            self._extreme_batch = context.train_batch

    def on_train_loader_end(self, context: PhaseContext):
        if self._extreme_batch is None or context.epoch % self.freq != 0:
            return
        self._visualize(context, self._extreme_batch, self._extreme_loss)

    def _visualize(self, context, batch, loss):
        pass

    def _tag(self):
        return f"extreme_batch_{'max' if self.max_ else 'min'}_loss"


@register_callback("ExtremeBatchDetectionVisualizationCallback")
class ExtremeBatchDetectionVisualizationCallback(ExtremeBatchCaseVisualizationCallback):
    """The extreme-loss train batch's predictions, drawn by the epoch's trained network."""

    def _visualize(self, context, batch, loss):
        model = context.model
        if getattr(model, "task", None) != "detection":
            return
        images, nms = detect_for_visualization(context.eval_net, batch[0][: self.max_images],
                                               loader_max_value(context.train_loader), 0.25)
        for j, drawn in enumerate(draw_detections(model, images, nms)):
            if context.sg_logger is not None:
                context.sg_logger.add_image(f"{self._tag()}/img{j} (loss={loss:.3f})", drawn, context.epoch)
