"""String-name registries of the port (counterpart of
``super_gradients_tpu/common/registry.py``).

The port keeps its own dicts, so that ``yolo_nas_m`` or ``PPYoloELoss`` here never
collides with the JAX package's entry of the same name.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


class RegistryError(KeyError):
    pass


def create_register_decorator(registry: Dict[str, object]) -> Callable:
    """Create a ``@register(name=None)`` decorator bound to ``registry``."""

    def register(name: Optional[str] = None) -> Callable:
        def decorator(obj):
            key = name if name is not None else obj.__name__
            if key in registry and registry[key] is not obj:
                raise RegistryError(f"`{key}` already registered as {registry[key]!r}")
            registry[key] = obj
            return obj

        return decorator

    return register


ARCHITECTURES: Dict[str, Callable] = {}
LOSSES: Dict[str, Callable] = {}
METRICS: Dict[str, Callable] = {}
CALLBACKS: Dict[str, Callable] = {}
LR_SCHEDULERS: Dict[str, Callable] = {}
OPTIMIZERS: Dict[str, Callable] = {}
SG_LOGGERS: Dict[str, Callable] = {}
DATALOADERS: Dict[str, Callable] = {}

register_model = create_register_decorator(ARCHITECTURES)
register_loss = create_register_decorator(LOSSES)
register_metric = create_register_decorator(METRICS)
register_callback = create_register_decorator(CALLBACKS)
register_lr_scheduler = create_register_decorator(LR_SCHEDULERS)
register_optimizer = create_register_decorator(OPTIMIZERS)
register_sg_logger = create_register_decorator(SG_LOGGERS)
register_dataloader = create_register_decorator(DATALOADERS)
