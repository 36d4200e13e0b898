"""Object-from-config factories (counterpart of ``super_gradients_tpu/common/factories.py``).

A config value that names an object may be a plain string (``"DetectionMetrics"``),
a one-key dict (``{"DetectionMetrics": {"num_cls": 80}}``) or an already-built
instance; :class:`BaseFactory` resolves all three.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional


class FactoryError(ValueError):
    pass


def not_ported_error(kind: str, name: str, roadmap_item: str) -> KeyError:
    """The error for a name the JAX package registers and the port does not yet."""
    return KeyError(f"{kind} `{name}` is not ported to super_gradients_tpu_torch yet ({roadmap_item})")


class BaseFactory:
    """Resolve ``str | {name: params} | instance`` into an instance.

    ``not_ported`` maps names registered in the JAX package but not here to their
    ROADMAP item; asking for one raises ``KeyError`` naming it. An unknown name
    raises ``unknown_error`` (the JAX package's callback and logger lookups raise
    ``KeyError``, its factories ``FactoryError``).
    """

    def __init__(self, type_dict: Mapping[str, Callable], not_ported: Optional[Mapping[str, str]] = None,
                 kind: str = "type", unknown_error: type = FactoryError):
        self.type_dict = type_dict
        self.not_ported = dict(not_ported or {})
        self.kind = kind
        self.unknown_error = unknown_error

    def get(self, conf: Any) -> Any:
        if conf is None:
            return None
        if isinstance(conf, str):
            return self._instantiate(conf, {})
        if isinstance(conf, Mapping):
            if len(conf) != 1:
                raise FactoryError(f"Factory config dict must have exactly one key (the type name); got {list(conf)}")
            ((name, params),) = conf.items()
            return self._instantiate(name, dict(params or {}))
        return conf  # already an instance

    def _instantiate(self, name: str, params: Dict[str, Any]) -> Any:
        if name not in self.type_dict:
            if name in self.not_ported:
                raise not_ported_error(self.kind, name, self.not_ported[name])
            close = [k for k in self.type_dict if k.lower() == name.lower()]
            hint = f" Did you mean `{close[0]}`?" if close else ""
            raise self.unknown_error(f"Unknown {self.kind} name `{name}`. Registered: {sorted(self.type_dict)}.{hint}")
        return self.type_dict[name](**params)
