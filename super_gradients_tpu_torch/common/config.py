"""Recipes (counterpart of ``super_gradients_tpu/common/config.py``).

``load_recipe(name, config_dir, overrides)`` reads a YAML recipe, composes its
``defaults:`` list (``training_hyperparams: default_train_params`` loads
``<config_dir>/training_hyperparams/default_train_params.yaml``) with the recipe
body winning, applies dotted ``a.b=v`` overrides, resolves ``${a.b}``
interpolations and expands the flat shortcuts (``lr=``, ``batch_size=``,
``epochs=``, ...). Recipes are plain nested dicts.

``load_arch_params(name)`` reads an ``arch_params/`` group file (the YOLO-NAS S / M / L
module-spec trees, which ``models.get(..., arch_params=...)`` builds from).
:class:`HpmStruct` is an attribute-access parameter struct, and
:class:`raise_if_unused_params` a context manager that raises when a config key was
never read.

The built-in recipes are the port's own copies in ``super_gradients_tpu_torch/recipes/``,
byte-equal to the JAX package's files of the same name. PyYAML is imported where a
file or an override value is parsed, never at import time: without it those calls
raise an ``ImportError`` that names it.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence

_PKG_RECIPE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "recipes")


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading a YAML recipe or override needs PyYAML (`import yaml`), which is not installed; "
                          "load a resolved recipe from JSON and pass the dict to Trainer.train_from_config") from e
    return yaml


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursively merge ``override`` into ``base`` (override wins). Returns new dict."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def _get_path(tree: Dict, dotted: str) -> Any:
    node: Any = tree
    for part in dotted.split("."):
        if isinstance(node, Mapping) and part in node:
            node = node[part]
        else:
            raise KeyError(f"Interpolation key `{dotted}` not found (missing `{part}`)")
    return node


def resolve_interpolations(tree: Dict) -> Dict:
    """Resolve ``${a.b}`` references against the root of ``tree`` (multi-pass)."""

    def resolve_value(v: Any) -> Any:
        if isinstance(v, str):
            m = _INTERP_RE.fullmatch(v.strip())
            if m:  # whole-string interpolation: preserve type
                return _get_path(tree, m.group(1))
            return _INTERP_RE.sub(lambda mm: str(_get_path(tree, mm.group(1))), v)
        if isinstance(v, Mapping):
            return {k: resolve_value(x) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve_value(x) for x in v]
        return v

    prev = None
    out = tree
    for _ in range(10):  # chained interpolations
        out = resolve_value(out)
        if out == prev:
            break
        prev = out
    return out


def _load_yaml(path: str) -> Dict:
    yaml = _yaml()
    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def _resolve_group_file(config_dir: str, group: str, name: str) -> str:
    p = os.path.join(config_dir, group, f"{name}.yaml")
    if os.path.exists(p):
        return p
    builtin = os.path.join(_PKG_RECIPE_DIR, group, f"{name}.yaml")
    if os.path.exists(builtin):
        return builtin
    raise FileNotFoundError(f"Config group file not found: {group}/{name}.yaml (searched {config_dir} and builtin recipes)")


def load_recipe(config_name: str, config_dir: Optional[str] = None, overrides: Optional[Sequence[str]] = None) -> Dict:
    """Load and compose a recipe, as the JAX package's ``load_recipe``."""
    config_dir = config_dir or _PKG_RECIPE_DIR
    if config_name.endswith(".yaml"):
        recipe_path = config_name if os.path.isabs(config_name) else os.path.join(config_dir, config_name)
    else:
        recipe_path = os.path.join(config_dir, f"{config_name}.yaml")
        if not os.path.exists(recipe_path):
            recipe_path = os.path.join(_PKG_RECIPE_DIR, f"{config_name}.yaml")
    raw = _load_yaml(recipe_path)

    defaults = raw.pop("defaults", [])
    merged: Dict = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            merged = deep_merge(merged, raw)
            self_merged = True
            continue
        if isinstance(entry, Mapping):
            (group, name), = entry.items()
            if name is None:
                continue
            sub = _load_yaml(_resolve_group_file(config_dir, str(group), str(name)))
            # nested defaults inside a group file merge within the same group
            sub_defaults = sub.pop("defaults", [])
            for sd in sub_defaults:
                if sd == "_self_" or not isinstance(sd, Mapping):
                    continue
                (g2, n2), = sd.items()
                sub2 = _load_yaml(_resolve_group_file(config_dir, str(g2), str(n2)))
                sub = deep_merge(sub2, sub)
            merged = deep_merge(merged, {str(group): sub})
        else:  # bare file include at root
            sub = _load_yaml(_resolve_group_file(config_dir, "", str(entry)) if "/" in str(entry) else os.path.join(config_dir, f"{entry}.yaml"))
            merged = deep_merge(merged, sub)
    if not self_merged:
        merged = deep_merge(merged, raw)

    if overrides:
        merged = add_params_to_cfg(merged, overrides)
    return apply_recipe_shortcuts(resolve_interpolations(merged))


# Flat shortcut keys and the nested paths they fan out to (``num_workers`` sets both
# loaders'). A shortcut left unset is filled back from its nested value.
RECIPE_SHORTCUTS: Dict[str, List[str]] = {
    "lr": ["training_hyperparams.initial_lr"],
    "batch_size": ["dataset_params.train_dataloader_params.batch_size"],
    "val_batch_size": ["dataset_params.val_dataloader_params.batch_size"],
    "ema": ["training_hyperparams.ema"],
    "epochs": ["training_hyperparams.max_epochs"],
    "resume": ["training_hyperparams.resume"],
    "num_workers": [
        "dataset_params.train_dataloader_params.num_workers",
        "dataset_params.val_dataloader_params.num_workers",
    ],
}


def apply_recipe_shortcuts(cfg: Dict) -> Dict:
    """Expand flat shortcut keys (``lr=``, ``batch_size=``, ``epochs=``, ...) into their
    nested recipe paths; back-fill unset shortcuts from the nested values.

    Only for root recipes (a ``training_hyperparams`` group or an ``architecture``):
    in a group file such as ``training_hyperparams/default_train_params.yaml``,
    ``ema`` and ``resume`` are real parameters, not shortcuts.
    """
    if not (isinstance(cfg.get("training_hyperparams"), dict) or "architecture" in cfg):
        return cfg
    for key, targets in RECIPE_SHORTCUTS.items():
        short_val = cfg.get(key)
        for dotted in targets:
            parts = dotted.split(".")
            if short_val is not None:
                node = cfg
                for part in parts[:-1]:
                    nxt = node.get(part)
                    if not isinstance(nxt, dict):
                        nxt = {}
                        node[part] = nxt
                    node = nxt
                node[parts[-1]] = copy.deepcopy(short_val)
            elif key in cfg:
                node = cfg
                for part in parts[:-1]:
                    node = node.get(part) if isinstance(node, dict) else None
                    if node is None:
                        break
                if isinstance(node, dict) and node.get(parts[-1]) is not None:
                    cfg[key] = node[parts[-1]]  # back-populate declared-but-unset shortcut
    return cfg


def add_params_to_cfg(cfg: Dict, params: Sequence[str]) -> Dict:
    """Apply dotted ``key=value`` overrides; each value is parsed as YAML."""
    out = copy.deepcopy(cfg)
    for p in params:
        if "=" not in p:
            raise ValueError(f"Override `{p}` must be key=value")
        key, _, val = p.partition("=")
        parsed = _yaml().safe_load(val) if val != "" else None
        node = out
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = parsed
    return out


def load_arch_params(config_name: str, recipes_dir_path: Optional[str] = None,
                     overriding_params: Optional[Dict] = None) -> Dict:
    """An ``arch_params/`` group file, e.g. ``load_arch_params("yolo_nas_s_arch_params")``:
    its ``defaults:`` entries merged under it, then ``overriding_params`` on top."""
    base = recipes_dir_path or _PKG_RECIPE_DIR
    params = _load_yaml(_resolve_group_file(base, "arch_params", config_name))
    for entry in params.pop("defaults", []):
        if entry == "_self_":
            continue
        params = deep_merge(load_arch_params(str(entry), recipes_dir_path=recipes_dir_path), params)
    params.update(overriding_params or {})
    return resolve_interpolations(params)


class HpmStruct:
    """Attribute-access hyper-parameter struct."""

    def __init__(self, **entries):
        self.__dict__.update(entries)

    def set_schema(self, schema):
        self.__dict__["_schema"] = schema

    def override(self, **entries):
        self.__dict__.update(entries)
        return self

    def to_dict(self, include_schema: bool = False) -> Dict:
        return {k: v for k, v in self.__dict__.items() if include_schema or k != "_schema"}

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):
        return f"HpmStruct({self.to_dict()!r})"


class _TrackedDict(dict):
    """A dict that records every key read through it (as ``prefix.key``); a nested dict
    read through it comes back tracked too."""

    def __init__(self, data: Dict, used: set, prefix: str):
        super().__init__(data)
        self._used = used
        self._prefix = prefix

    def __getitem__(self, key):
        self._used.add(self._prefix + str(key))
        v = super().__getitem__(key)
        if isinstance(v, dict) and not isinstance(v, _TrackedDict):
            return _TrackedDict(v, self._used, self._prefix + str(key) + ".")
        return v

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default


class UnusedConfigParamError(ValueError):
    pass


class raise_if_unused_params:
    """Context manager over a config dict: on a clean exit it raises
    :class:`UnusedConfigParamError` naming every top-level key that was never read."""

    def __init__(self, cfg: Dict):
        self._used: set = set()
        self.cfg = _TrackedDict(cfg, self._used, "")
        self._keys = set(map(str, cfg.keys()))

    def __enter__(self):
        return self.cfg

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            unused = self._keys - {u.split(".")[0] for u in self._used}
            if unused:
                raise UnusedConfigParamError(f"Unused config params: {sorted(unused)}")
        return False
