"""Collectives across ranks (counterpart of ``super_gradients_tpu/parallel/collectives.py``).

Each helper is an identity in one process. Under a process group a sum stays on its
tensor's device (gloo reduces CPU and CUDA tensors alike; NCCL takes CUDA tensors only,
so a CPU tensor goes to the rank's GPU), which keeps a sum's backward in the autograd
thread of that device, in the order DDP's gradient all-reduces see it on every rank. A
gather travels on the rank's GPU for NCCL and on the CPU for gloo (which gathers no CUDA
tensor), so host arrays go through either backend.

:func:`global_normalizer` makes a loss normalizer global: a loss divides its rank's sum
by ``global_normalizer(local count)``, the global count over the world size, so that
DDP's mean of the ranks' gradients is the gradient of the global batch's loss
(``sum_r sum_r / count``), and the mean of the ranks' losses its value.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from super_gradients_tpu_torch.common.environment import get_world_size, process_group_active

ROADMAP_DDP = "ROADMAP.md queue 1, item 8, 'Deployment and scale-out'"


def is_distributed() -> bool:
    """More than one rank."""
    return get_world_size() > 1


def refuse_across_ranks(what: str) -> None:
    """Raise where ``what`` would give a per-rank value under more than one rank."""
    if is_distributed():
        raise NotImplementedError(f"{what} is not exact across ranks yet: it would see one rank's share of the "
                                  f"global batch ({ROADMAP_DDP}); train it in one process")


def _comm_device() -> torch.device:
    """Where a gather travels."""
    return torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")


def _sum_device(t: torch.Tensor) -> torch.device:
    """Where a sum of ``t`` travels: its own device, unless NCCL needs it on the GPU."""
    return _comm_device() if dist.get_backend() == "nccl" and t.device.type != "cuda" else t.device


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's copy is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, on ``t``'s device; the gradient flows back to every rank
    where ``t`` requires one."""
    if not process_group_active():
        return t
    x = t.to(_sum_device(t))
    if t.requires_grad:
        return _AllReduceSum.apply(x).to(t.device)
    x = x.detach().clone()
    dist.all_reduce(x)
    return x.to(t.device)


def global_normalizer(count: torch.Tensor) -> torch.Tensor:
    """A loss's normalizer over the global batch, shared out over the ranks: ``count``
    summed over the ranks, clamped at 1 after the sum (as the JAX losses clamp the global
    batch's count), over the world size; ``count.clamp(min=1)`` in one process."""
    return global_sum(count).clamp(min=1.0) / get_world_size()


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x``'s elements over every rank's ``x``, shared out as the losses'
    normalizers are (``x.mean()`` in one process)."""
    if not process_group_active():
        return x.mean()
    count = global_sum(torch.tensor(float(x.numel()), dtype=torch.float64, device=x.device))
    return x.sum() / (count / get_world_size()).to(x.dtype)


def _all_reduce_leaf(x):
    if isinstance(x, torch.Tensor):
        return global_sum(x.detach())
    if isinstance(x, (bool, np.bool_)):
        raise TypeError("a bool does not sum across ranks")
    if isinstance(x, (int, np.integer)):
        return int(global_sum(torch.tensor(int(x), dtype=torch.int64)))
    if isinstance(x, (float, np.floating)):
        return float(global_sum(torch.tensor(float(x), dtype=torch.float64)))
    if isinstance(x, np.ndarray):
        return global_sum(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    raise TypeError(f"cannot sum a {type(x).__name__} across ranks")


def sum_across_processes(tree: Any) -> Any:
    """Every number, array and tensor of a dict / list / tuple tree summed over the ranks."""
    if not process_group_active():
        return tree
    if isinstance(tree, dict):
        return {k: sum_across_processes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sum_across_processes(v) for v in tree)
    return _all_reduce_leaf(tree)


def maybe_pmean_across_hosts(tree: Any) -> Any:
    """The mean over the ranks of every number, array and tensor of a tree."""
    if not process_group_active():
        return tree
    world = get_world_size()
    summed = sum_across_processes(tree)

    def mean(x):
        if isinstance(x, dict):
            return {k: mean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(mean(v) for v in x)
        return x / world

    return mean(summed)


def all_gather_from_hosts(x: Any) -> List[Any]:
    """Every rank's ``x`` (any picklable value), in rank order; ``[x]`` in one process."""
    if not process_group_active():
        return [x]
    out = [None] * get_world_size()
    dist.all_gather_object(out, x)
    return out


def broadcast_from_primary(x: Any) -> Any:
    """Rank 0's ``x`` (any picklable value) on every rank."""
    if not process_group_active():
        return x
    box = [x]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_per_rank(arrays: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """Every rank's dict of arrays, in rank order, where the arrays' leading dimension
    differs across ranks (the same within a rank): padded to the longest, gathered as
    tensors on the backend's device, the padding stripped."""
    if not process_group_active():
        return [dict(arrays)]
    keys = sorted(arrays)
    n_local = len(arrays[keys[0]]) if keys else 0
    lengths = [int(n) for n in all_gather_from_hosts(n_local)]
    n_max, comm = max(lengths), _comm_device()
    out: List[Dict[str, np.ndarray]] = [{} for _ in lengths]
    for k in keys:
        a = np.asarray(arrays[k])
        as_bool = a.dtype == np.bool_
        a = a.astype(np.uint8) if as_bool else a  # gloo gathers no bool tensor
        padded = np.zeros((n_max,) + a.shape[1:], a.dtype)
        padded[: len(a)] = a
        t = torch.from_numpy(padded).to(comm)
        parts = [torch.empty_like(t) for _ in lengths]
        dist.all_gather(parts, t)
        for r, (part, n) in enumerate(zip(parts, lengths)):
            g = part[:n].cpu().numpy()
            out[r][k] = g.astype(np.bool_) if as_bool else g
    return out


def all_gather_variable_length(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every rank's arrays concatenated in rank order along their leading dimension,
    which may differ across ranks (host metric states); the arrays as they are in one
    process."""
    if not process_group_active():
        return dict(arrays)
    parts = all_gather_per_rank(arrays)
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in arrays}
