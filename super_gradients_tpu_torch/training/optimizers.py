"""Optimizer factory on ``torch.optim`` (counterpart of
``super_gradients_tpu/training/optimizers.py``).

The JAX package chains optax transforms; here each piece becomes a param-group
setting of one ``torch.optim`` optimizer:

- the zero-weight-decay mask (weight decay on rank >= 2 tensors only, i.e. conv
  and linear weights; none on biases, BN affine parameters or ``alpha``) splits
  the parameters into groups with and without ``weight_decay``;
- ``lr_group_dict`` (per-prefix learning rates) gives each group an ``lr_mult``;
  the trainer sets ``group["lr"] = schedule(step) * group["lr_mult"]``.

SGD takes the decay coupled, added to the gradient before momentum (optax
``add_decayed_weights`` before ``sgd``), which is what ``torch.optim.SGD`` does.
``Adam`` with a weight decay is optax's ``adamw``, so it maps to ``AdamW``.
``RMSProp`` and ``Lion`` are optax's, written here (:class:`RMSProp`, :class:`Lion`):
``torch.optim.RMSprop`` puts eps outside the square root and the LR outside the momentum
buffer, and torch has no Lion.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from super_gradients_tpu_torch.common.registry import OPTIMIZERS, register_optimizer

def _decay_groups(param_groups: List[Dict], weight_decay: float) -> List[Dict]:
    return [dict(g, weight_decay=weight_decay if g["decay"] else 0.0) for g in param_groups]


@register_optimizer("SGD")
def sgd(param_groups, momentum: float = 0.9, weight_decay: float = 0.0, nesterov: bool = False, **kw):
    return torch.optim.SGD(_decay_groups(param_groups, weight_decay), lr=0.0, momentum=momentum, nesterov=nesterov)


@register_optimizer("Adam")
def adam(param_groups, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, **kw):
    opt = torch.optim.AdamW if weight_decay else torch.optim.Adam
    return opt(_decay_groups(param_groups, weight_decay), lr=0.0, betas=(b1, b2), eps=eps)


@register_optimizer("AdamW")
def adamw(param_groups, weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, **kw):
    return torch.optim.AdamW(_decay_groups(param_groups, weight_decay), lr=0.0, betas=(b1, b2), eps=eps)


class RMSProp(torch.optim.Optimizer):
    """optax's ``rmsprop(lr, decay, eps, momentum)`` with its defaults (eps inside the root,
    no bias correction, accumulators from 0), after the coupled weight decay that the JAX
    package chains before it (``add_decayed_weights``, masked by the param groups)::

        g += weight_decay * p
        nu = decay * nu + (1 - decay) * g ** 2
        t = lr * g / sqrt(nu + eps) + momentum * t
        p -= t
    """

    def __init__(self, params, lr: float = 0.0, decay: float = 0.9, eps: float = 1e-8, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        # "nu_decay": the param groups' "decay" is the weight-decay flag of build_optimizer
        super().__init__(params, dict(lr=lr, nu_decay=decay, eps=eps, momentum=momentum, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            for p in params:
                if not self.state[p]:
                    self.state[p] = {"nu": torch.zeros_like(p), "trace": torch.zeros_like(p)}
            nu = [self.state[p]["nu"] for p in params]
            trace = [self.state[p]["trace"] for p in params]
            torch._foreach_mul_(nu, group["nu_decay"])
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - group["nu_decay"])
            denom = torch._foreach_sqrt(torch._foreach_add(nu, group["eps"]))
            update = torch._foreach_div(torch._foreach_mul(grads, group["lr"]), denom)
            torch._foreach_mul_(trace, group["momentum"])
            torch._foreach_add_(trace, update)
            torch._foreach_sub_(params, trace)


class Lion(torch.optim.Optimizer):
    """optax's ``lion(lr, b1, b2, weight_decay, mask)``, its decay decoupled and masked by the
    param groups::

        p -= lr * (sign(b1 * m + (1 - b1) * g) + weight_decay * p)
        m = b2 * m + (1 - b2) * g
    """

    def __init__(self, params, lr: float = 0.0, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p] = {"mu": torch.zeros_like(p)}
            mu = [self.state[p]["mu"] for p in params]
            direction = torch._foreach_mul(grads, 1.0 - group["b1"])
            torch._foreach_add_(direction, torch._foreach_mul(mu, group["b1"]))
            direction = torch._foreach_sign(direction)
            if group["weight_decay"]:
                torch._foreach_add_(direction, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, direction, alpha=-group["lr"])
            torch._foreach_mul_(mu, group["b2"])
            torch._foreach_add_(mu, grads, alpha=1.0 - group["b2"])


@register_optimizer("RMSProp")
@register_optimizer("RMSprop")  # the original spells it both ways
def rmsprop(param_groups, momentum: float = 0.9, weight_decay: float = 0.0, decay: float = 0.9, eps: float = 1e-8,
            **kw):
    return RMSProp(_decay_groups(param_groups, weight_decay), decay=decay, eps=eps, momentum=momentum)


@register_optimizer("Lion")
def lion(param_groups, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.99, **kw):
    return Lion(_decay_groups(param_groups, weight_decay), b1=b1, b2=b2)


def lr_group_multipliers(names: Iterable[str], lr_dict: Dict[str, float]) -> Dict[str, float]:
    """Each parameter's LR multiplier from ``{name prefix: lr, "default": lr}``.

    The longest matching prefix wins (a prefix matches at the start of the dotted
    name or after a dot); multipliers are relative to ``lr_dict["default"]``, which
    drives the schedule. ``lr == 0`` freezes the group.
    """
    if "default" not in lr_dict:
        raise RuntimeError("When passing initial_lr as a dictionary, must pass 'default'.")
    default = float(lr_dict["default"])
    groups = {k: float(v) for k, v in lr_dict.items() if k != "default"}
    if default == 0 and any(v for v in groups.values()):
        raise RuntimeError("initial_lr['default'] must be non-zero when other groups train")

    def mult_for(name: str) -> float:
        best = None
        for prefix, lr in groups.items():
            if (name.startswith(prefix) or ("." + prefix) in name) and (best is None or len(prefix) > best[0]):
                best = (len(prefix), lr)
        lr = best[1] if best is not None else default
        return lr / default if default else 0.0

    return {name: mult_for(name) for name in names}


def build_optimizer(
    optimizer: str,
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    optimizer_params: Optional[Dict] = None,
    zero_weight_decay_on_bias_and_bn: bool = False,
    lr_group_dict: Optional[Dict[str, float]] = None,
) -> torch.optim.Optimizer:
    """A ``torch.optim`` optimizer over ``named_params``, its param groups keyed by
    (weight decay or not, LR multiplier). Its LR is 0 until the trainer sets it."""
    if optimizer not in OPTIMIZERS:
        by_lower = {k.lower(): k for k in OPTIMIZERS}
        optimizer = by_lower.get(str(optimizer).lower(), optimizer)
    if optimizer not in OPTIMIZERS:
        raise KeyError(f"Unknown optimizer `{optimizer}`; registered: {sorted(OPTIMIZERS)}")
    opt_params = dict(optimizer_params or {})
    for k, v in opt_params.items():  # YAML 1.1 reads a bare 1e-4 as a string
        if isinstance(v, str):
            try:
                opt_params[k] = float(v)
            except ValueError:
                pass

    named_params = list(named_params)
    mults = lr_group_multipliers([n for n, _ in named_params], lr_group_dict) if lr_group_dict else {}
    groups: Dict[Tuple[bool, float], List[torch.nn.Parameter]] = {}
    for name, p in named_params:
        decay = p.ndim >= 2 if zero_weight_decay_on_bias_and_bn else True
        groups.setdefault((decay, mults.get(name, 1.0)), []).append(p)
    param_groups = [{"params": ps, "decay": decay, "lr_mult": mult} for (decay, mult), ps in groups.items()]
    return OPTIMIZERS[optimizer](param_groups=param_groups, **opt_params)
