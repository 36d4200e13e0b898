"""TrainState (counterpart of ``super_gradients_tpu/training/train_state.py``).

The JAX package keeps the whole training world in one immutable pytree; here it is
a plain holder of the mutable torch objects the train loop updates in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from super_gradients_tpu_torch.training.ema import ModelEMA


@dataclasses.dataclass
class TrainState:
    net: nn.Module  # the network being trained (a copy of the model's)
    optimizer: torch.optim.Optimizer
    ema: Optional[ModelEMA] = None
    step: int = 0  # micro-steps taken (batches); optimizer steps = step // batch_accumulate
