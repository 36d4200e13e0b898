"""Model EMA (counterpart of ``super_gradients_tpu/training/ema.py``).

An fp32 shadow of the network's parameters and floating-point buffers (the
BatchNorm running mean and variance; ``num_batches_tracked`` is not averaged),
updated after each optimizer step with the decay of the step count before it. Tensors
that never change are not averaged and stay bit for bit: frozen parameters
(``requires_grad`` off) and, in a network built in train mode, the buffers of the modules
held in eval mode (a knowledge-distillation teacher).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

DecayFn = Callable[[float], float]  # optimizer step -> decay


def make_decay_fn(decay: float = 0.9999, decay_type: str = "exp", beta: float = 15.0, total_steps: int = 1) -> DecayFn:
    """constant | threshold | exp decay schedules."""
    if decay_type == "constant":
        return lambda step: decay
    if decay_type == "threshold":
        return lambda step: min(decay, (1.0 + step) / (10.0 + step))
    if decay_type == "exp":
        return lambda step: decay * (1.0 - math.exp(-(step / total_steps) * beta))
    raise ValueError(f"Unknown EMA decay_type `{decay_type}` (constant|threshold|exp)")


def _tracked(net: nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors the EMA follows, by state_dict name: trainable parameters, and the
    floating-point buffers of the modules that train with the network."""
    out = {name: p for name, p in net.named_parameters() if p.requires_grad}
    for prefix, module in net.named_modules():
        if module.training or not net.training:
            out.update({f"{prefix}.{name}" if prefix else name: b
                        for name, b in module.named_buffers(recurse=False) if b.is_floating_point()})
    return out


class ModelEMA:
    """``ema = decay * ema + (1 - decay) * live`` over a network's tracked tensors.

    The network is updated in place by the optimizer and by BatchNorm, so the EMA
    keeps references to its live tensors and walks no module tree per step.
    """

    def __init__(self, net: nn.Module):
        self.net = net
        tracked = _tracked(net)
        self.names: List[str] = list(tracked)
        self._live: List[torch.Tensor] = [t.detach() for t in tracked.values()]
        self.tensors: List[torch.Tensor] = [t.clone() for t in self._live]

    @torch.no_grad()
    def update(self, decay: float) -> None:
        torch._foreach_mul_(self.tensors, decay)
        torch._foreach_add_(self.tensors, self._live, alpha=1.0 - decay)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The network's state_dict with the averaged tensors in place of the live ones."""
        sd = self.net.state_dict()
        sd.update(zip(self.names, self.tensors))
        return sd

    @torch.no_grad()
    def load_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Set the averaged tensors from a state_dict of :meth:`state_dict`'s form."""
        missing = [n for n in self.names if n not in state_dict]
        if missing:
            raise KeyError(f"EMA state_dict lacks {missing[:5]}")
        for name, t in zip(self.names, self.tensors):
            t.copy_(state_dict[name])

    @torch.no_grad()
    def reset_to_live(self) -> None:
        """Restart the average from the network's current tensors."""
        for t, live in zip(self.tensors, self._live):
            t.copy_(live)
