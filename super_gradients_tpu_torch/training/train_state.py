"""TrainState (counterpart of ``super_gradients_tpu/training/train_state.py``).

The JAX package keeps the whole training world in one immutable pytree; here it is
a plain holder of the mutable torch objects the train loop updates in place.
:meth:`TrainState.state_dict` / :meth:`TrainState.load_state_dict` carry the
network, the optimizer, the EMA and the step count through a checkpoint, in the
checkpoint layout's keys.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import torch
from torch import nn

from super_gradients_tpu_torch.training.ema import ModelEMA

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    net: nn.Module  # the network being trained (a copy of the model's)
    optimizer: torch.optim.Optimizer
    ema: Optional[ModelEMA] = None
    step: int = 0  # micro-steps taken (batches); optimizer steps = step // batch_accumulate

    def state_dict(self) -> Dict:
        return {
            "net": self.net.state_dict(),
            "ema_net": self.ema.state_dict() if self.ema is not None else None,
            "optimizer_state_dict": self.optimizer.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, state: Dict, load_optimizer: bool = True) -> None:
        """Restore from :meth:`state_dict`'s form; ``load_optimizer=False`` keeps the
        optimizer fresh (momentum and moments start at zero)."""
        self.net.load_state_dict(state["net"])
        if self.ema is not None:
            if state.get("ema_net"):
                self.ema.load_state_dict(state["ema_net"])
            else:
                logger.warning("the checkpoint has no EMA weights: the EMA restarts from the restored weights")
                self.ema.reset_to_live()
        if load_optimizer:
            self.optimizer.load_state_dict(state["optimizer_state_dict"])
        self.step = int(state["step"])
