"""Experiment loggers (counterpart of ``super_gradients_tpu/common/sg_loggers.py``).

``base_sg_logger`` writes scalars, config and text as JSON lines to
``<checkpoints dir>/events.jsonl``, and to TensorBoard event files under
``<checkpoints dir>/tensorboard`` where ``torch.utils.tensorboard`` imports.
Images go to TensorBoard only (the JAX logger's PNG copy needs an image library).
``monitor_system`` and the remote loggers are not ported and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from super_gradients_tpu_torch.common.environment import is_primary_process
from super_gradients_tpu_torch.common.factories import BaseFactory
from super_gradients_tpu_torch.common.registry import SG_LOGGERS, register_sg_logger

logger = logging.getLogger(__name__)

_LEFTOVERS = "ROADMAP.md queue 1, 'Training leftovers'"


class AbstractSGLogger:
    def add_config(self, tag: str, config: Dict):
        pass

    def add_scalar(self, tag: str, value: float, global_step: int = 0):
        pass

    def add_scalars(self, tag_scalar_dict: Dict[str, float], global_step: int = 0):
        for k, v in tag_scalar_dict.items():
            self.add_scalar(k, v, global_step)

    def add_image(self, tag: str, image: np.ndarray, global_step: int = 0):
        pass

    def add_text(self, tag: str, text: str, global_step: int = 0):
        pass

    def add_checkpoint(self, tag: str, state_dict: Any, global_step: int = 0):
        pass

    def upload(self):
        pass

    def flush(self):
        pass

    def close(self):
        pass


@register_sg_logger("base_sg_logger")
class BaseSGLogger(AbstractSGLogger):
    """JSON lines + TensorBoard in the checkpoints directory (process 0 only)."""

    def __init__(self, experiment_name: str = "experiment", storage_location: Optional[str] = None,
                 checkpoints_dir_path: Optional[str] = None, monitor_system: bool = False, tensorboard: bool = True,
                 **kwargs):
        if monitor_system:
            raise NotImplementedError(f"sg_logger_params.monitor_system needs common/monitoring.py, not ported yet ({_LEFTOVERS})")
        self.experiment_name = experiment_name
        self.dir = checkpoints_dir_path or storage_location or "."
        self._jsonl = None
        self._tb = None
        if is_primary_process():
            os.makedirs(self.dir, exist_ok=True)
            self._jsonl = open(os.path.join(self.dir, "events.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(log_dir=os.path.join(self.dir, "tensorboard"))
                except Exception as e:  # TensorBoard is optional
                    logger.debug(f"TensorBoard writer unavailable: {e}")

    def add_config(self, tag: str, config: Dict):
        if self._jsonl:
            self._jsonl.write(json.dumps({"type": "config", "tag": tag, "config": config, "ts": time.time()}, default=str) + "\n")
            self._jsonl.flush()
        if self._tb:
            self._tb.add_text(tag, f"```\n{json.dumps(config, indent=2, default=str)}\n```")

    def add_scalar(self, tag: str, value: float, global_step: int = 0):
        if self._jsonl:
            self._jsonl.write(json.dumps({"type": "scalar", "tag": tag, "value": float(value), "step": int(global_step)}) + "\n")
        if self._tb:
            self._tb.add_scalar(tag, float(value), int(global_step))

    def add_image(self, tag: str, image: np.ndarray, global_step: int = 0):
        if self._tb is not None:
            self._tb.add_image(tag, image, int(global_step), dataformats="HWC")

    def add_text(self, tag: str, text: str, global_step: int = 0):
        if self._jsonl:
            self._jsonl.write(json.dumps({"type": "text", "tag": tag, "text": text, "step": int(global_step)}) + "\n")
        if self._tb:
            self._tb.add_text(tag, text, int(global_step))

    def flush(self):
        if self._jsonl:
            self._jsonl.flush()
        if self._tb:
            self._tb.flush()

    def close(self):
        self.flush()
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None


def _remote_logger(name: str):
    @register_sg_logger(name)
    class RemoteSGLogger(AbstractSGLogger):
        def __init__(self, **kwargs):
            raise NotImplementedError(f"sg_logger `{name}` is not ported to super_gradients_tpu_torch yet ({_LEFTOVERS})")

    RemoteSGLogger.__name__ = RemoteSGLogger.__qualname__ = name
    return RemoteSGLogger


for _name in ("wandb_sg_logger", "clearml_sg_logger", "dagshub_sg_logger", "deci_platform_sg_logger"):
    _remote_logger(_name)


def get_sg_logger(name, **params) -> AbstractSGLogger:
    conf = {name: params} if isinstance(name, str) else name  # an instance passes as is
    return BaseFactory(SG_LOGGERS, kind="sg_logger", unknown_error=KeyError).get(conf)
