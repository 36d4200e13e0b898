"""Checkpoint files (counterpart of ``super_gradients_tpu/training/checkpoints.py``).

``<ckpt_dir>/<name>.pth`` files written by ``torch.save`` in the layout of the
original super-gradients (the one ``super_gradients_tpu/conversion/torch_converter.py``
reads): ``net`` (the live ``state_dict``), ``ema_net`` (the EMA weights, or None),
``optimizer_state_dict``, ``epoch`` and ``metrics``, plus ``step``, ``experiment``
and ``ckpt_version``. Each file is written to a temporary name and renamed, so an
interrupted save leaves the previous file whole. Files are read with
``torch.load(weights_only=True)``: tensors, numbers, strings and containers only.
"""

from __future__ import annotations

import io
import logging
import math
import os
from typing import Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

CKPT_VERSION = 2  # 2: with optimizer state


def checkpoint_path(ckpt_dir: str, name: str) -> str:
    return os.path.join(ckpt_dir, name if name.endswith(".pth") else f"{name}.pth")


def serialize(state: Dict) -> bytes:
    buf = io.BytesIO()
    torch.save(state, buf)
    return buf.getvalue()


def save_checkpoint(ckpt_dir: str, name: str, data: bytes) -> str:
    """Write ``data`` (a dict through :func:`serialize`) to ``<ckpt_dir>/<name>.pth``."""
    path = checkpoint_path(ckpt_dir, name)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def load_checkpoint(ckpt_dir: str, name: str, map_location="cpu") -> Dict:
    return torch.load(checkpoint_path(ckpt_dir, name), map_location=map_location, weights_only=True)


def load_metadata(ckpt_dir: str, name: str) -> Dict:
    """Everything of a checkpoint but its tensors' dicts (epoch, metrics, step, ...)."""
    ckpt = torch.load(checkpoint_path(ckpt_dir, name), map_location="cpu", weights_only=True, mmap=True)
    return {k: v for k, v in ckpt.items() if k not in ("net", "ema_net", "optimizer_state_dict")}


def checkpoint_exists(ckpt_dir: str, name: str) -> bool:
    return os.path.isfile(checkpoint_path(ckpt_dir, name))


def model_state_dict_of(ckpt: Dict) -> Dict[str, torch.Tensor]:
    """The weights of a checkpoint: ``ema_net`` if present, else ``net``; a file
    holding a bare ``state_dict`` (or ``{"state_dict": ...}``) is taken as is."""
    if "net" in ckpt or "ema_net" in ckpt:
        return ckpt["ema_net"] if ckpt.get("ema_net") else ckpt["net"]
    return ckpt.get("state_dict", ckpt)


def resolve_subtree_key(keys, subtree: str) -> Optional[str]:
    """The top-level module name among ``keys`` that ``subtree`` means (``backbone``,
    ``_backbone``), or None."""
    for cand in (subtree, f"_{subtree}", subtree.lstrip("_")):
        if cand in keys:
            return cand
    return None


def load_checkpoint_into_model(model, checkpoint_path: str, only_subtree: Optional[str] = None, strict: bool = True):
    """Load a ``.pth`` checkpoint into an SgModel through ``model.load_state_dict``.

    ``only_subtree="backbone"`` takes that top-level module's tensors from the file and
    keeps the model's own for the rest (the recipes' ``load_backbone``). With
    ``strict=False`` only the tensors whose name and shape match are taken."""
    src = model_state_dict_of(torch.load(checkpoint_path, map_location="cpu", weights_only=True))
    own = model.net.state_dict()
    if only_subtree:
        own_tops, src_tops = ({k.split(".", 1)[0] for k in sd} for sd in (own, src))
        model_key, src_key = resolve_subtree_key(own_tops, only_subtree), resolve_subtree_key(src_tops, only_subtree)
        if model_key is None or src_key is None:
            raise KeyError(f"only_subtree='{only_subtree}' matches no top-level module of the "
                           f"{'model' if model_key is None else 'checkpoint'} (model: {sorted(own_tops)}, "
                           f"checkpoint: {sorted(src_tops)})")
        src = {model_key + k[len(src_key):]: v for k, v in src.items() if k.split(".", 1)[0] == src_key}
        strict = False
    if not strict:
        src = transfer_weights(src, own)
    model.load_state_dict(src)
    logger.info(f"Loaded checkpoint from {checkpoint_path}" + (f" (subtree {only_subtree})" if only_subtree else ""))
    return model


class BestCheckpointTracker:
    """metric_to_watch bookkeeping: the first finite value, then each strict improvement."""

    def __init__(self, greater_is_better: bool = True):
        self.greater_is_better = greater_is_better
        self.best: Optional[float] = None

    def is_improvement(self, value: float) -> bool:
        if value is None or (isinstance(value, float) and math.isnan(value)):
            return False
        if self.best is None:
            self.best = value
            return True
        better = value > self.best if self.greater_is_better else value < self.best
        if better:
            self.best = value
        return better


class AverageBestModels:
    """Running average of the ``n_best`` best snapshots of the parameters.

    Snapshots are CPU copies. The average is the sum in snapshot order divided by
    the count, which is how ``np.mean`` over a stacked axis rounds, so it equals
    the JAX package's bit for bit on the same snapshots.
    """

    def __init__(self, n_best: int = 10, greater_is_better: bool = True):
        self.n_best = n_best
        self.greater_is_better = greater_is_better
        self.snapshots: List[Tuple[float, Dict[str, torch.Tensor]]] = []

    def update(self, metric: float, params: Dict[str, torch.Tensor]):
        params = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
        self.snapshots.append((metric, params))
        self.snapshots.sort(key=lambda t: -t[0] if self.greater_is_better else t[0])
        self.snapshots = self.snapshots[: self.n_best]

    def averaged_params(self) -> Optional[Dict[str, torch.Tensor]]:
        if not self.snapshots:
            return None
        trees = [p for _, p in self.snapshots]
        out = {}
        for k in trees[0]:
            acc = trees[0][k].clone()
            for t in trees[1:]:
                acc += t[k]
            out[k] = acc / len(trees)
        return out


def transfer_weights(src: Dict[str, torch.Tensor], dst: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of ``dst`` with every tensor whose name AND shape match taken from ``src``
    (the partial load of fine-tuning and head replacement); the rest keep ``dst``'s.
    The count of taken tensors is left in ``transfer_weights.last_transferred``."""
    out, transferred = {}, 0
    for k, v in dst.items():
        s = src.get(k)
        if s is not None and hasattr(s, "shape") and tuple(s.shape) == tuple(v.shape):
            out[k] = s
            transferred += 1
        else:
            out[k] = v
    transfer_weights.last_transferred = transferred
    return out
