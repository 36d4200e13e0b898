"""Metric base (counterpart of ``super_gradients_tpu/training/metrics/base.py``).

The JAX package splits a metric between the jitted eval step and the host. Here
the split is: :meth:`Metric.preprocess_device` runs on the model's device (NMS,
decode, top-k) and its result goes to the host once per batch
(:func:`to_host`); :meth:`Metric.update` then runs on the host in numpy, and
:meth:`Metric.compute` reduces the state to floats. A metric without
``host_update`` updates from the outputs where they lie.

Under a process group each rank updates on its slice of the data, and
:meth:`MetricCollection.compute` makes every metric global: a device metric's state
(counts, confusion matrices) is summed over the ranks (:meth:`Metric.reduce_across_processes`),
and a host metric gathers its state in its own ``compute``, as the JAX package's do.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from super_gradients_tpu_torch.parallel.collectives import ROADMAP_DDP, sum_across_processes


def to_host(tree: Any) -> Any:
    """Tensors of a (named) tuple / list / dict tree -> numpy arrays on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_host(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_host(t) for t in tree)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree


class Metric:
    """``init() -> state``, ``update(state, outputs, targets) -> state``, ``compute(state) -> {name: float}``.

    Host metrics (``host_update=True``, e.g. mAP matching) get ``preprocess_device``,
    which reduces the raw outputs on the device to what ``update`` needs.
    """

    name: str = "metric"
    #: if True, update() runs on the host (numpy) on preprocess_device()'s result
    host_update: bool = False
    greater_is_better: bool = True

    def init(self) -> Any:
        raise NotImplementedError

    def preprocess_device(self, outputs: Any, targets: Any) -> Any:
        """Reduction of the raw outputs, on their device, to what update() needs."""
        return outputs

    def update(self, state: Any, outputs: Any, targets: Any) -> Any:
        raise NotImplementedError

    def compute(self, state: Any) -> Dict[str, float]:
        raise NotImplementedError

    def reduce_across_processes(self, state: Any) -> Any:
        """The state over every rank's data: each count summed (unchanged in one process).
        A host metric gathers its state in :meth:`compute` instead."""
        if self.host_update:
            return state
        try:
            return sum_across_processes(state)
        except TypeError as e:
            raise NotImplementedError(f"{type(self).__name__}: its state does not sum across ranks ({e}); "
                                      f"{ROADMAP_DDP}") from e


class MetricCollection:
    """Named collection with a combined state tuple."""

    def __init__(self, metrics: Sequence[Metric]):
        self.metrics = list(metrics)

    def init(self):
        return tuple(m.init() for m in self.metrics)

    def update_device(self, states, outputs, targets):
        """Update the metrics that are not host metrics, on the outputs' device."""
        return tuple(m.update(s, outputs, targets) if not m.host_update else s for m, s in zip(self.metrics, states))

    def preprocess_device(self, outputs, targets):
        """The host metrics' device reductions (None for the others)."""
        return tuple(m.preprocess_device(outputs, targets) if m.host_update else None for m in self.metrics)

    def update_host(self, states, aux, targets):
        """aux: the per-metric preprocess_device results, already on the host."""
        return tuple(m.update(s, a, targets) if m.host_update else s for m, s, a in zip(self.metrics, states, aux))

    def has_host_metrics(self) -> bool:
        return any(m.host_update for m in self.metrics)

    def compute(self, states) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m, s in zip(self.metrics, states):
            out.update(m.compute(m.reduce_across_processes(s)))
        return out
