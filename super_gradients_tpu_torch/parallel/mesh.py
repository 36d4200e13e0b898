"""Process-group setup (counterpart of ``super_gradients_tpu/parallel/mesh.py``).

The JAX package trains data-parallel in one process over a device mesh: the recipe's
``batch_size`` is the global batch, which XLA shards over the devices. Here each GPU
(or CPU process) is one rank of a ``torch.distributed`` process group, launched by

    python3 -m torch.distributed.run --nproc_per_node=N -m super_gradients_tpu_torch.train_from_recipe \\
        --config-name=<recipe> num_devices=N ...

and :func:`setup_device` joins the group from the environment the launcher sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``). The
``batch_size`` stays the global batch: each rank loads its :func:`local_batch_slice`
of every global batch, BatchNorm takes its statistics over the global batch
(``parallel/sync_batch_norm.py``) and the losses and metrics cover the global batch, so
a run on N ranks equals the one-process run on the same global batches, up to the
order of the reductions.

The backend follows the device: NCCL on CUDA, gloo on the CPU. ``backend="gloo"`` on
CUDA is taken from the Python API only (two ranks can then share one GPU, which NCCL
refuses); it is printed. The mesh's ``model`` axis (``get_mesh``, ``batch_sharding``,
``shard_batch``, ``replicate``) has no counterpart.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from super_gradients_tpu_torch.common.environment import get_rank, get_world_size

DEFAULT_TIMEOUT_S = 1800.0  # a rank that waits this long in a collective fails the run instead of hanging it


class DeviceConfig:
    """This process's place in the run: its world size and rank, read from the process
    group (``common/environment.py``), and the device :func:`setup_device` gave it."""

    device: Optional[torch.device] = None

    @property
    def num_devices(self) -> int:
        return get_world_size()

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def is_distributed(self) -> bool:
        return self.num_devices > 1

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


device_config = DeviceConfig()


def launch_command(n: int) -> str:
    return (f"python3 -m torch.distributed.run --nproc_per_node={n} -m super_gradients_tpu_torch.train_from_recipe "
            f"--config-name=<recipe> num_devices={n} ...")


def setup_device(num_devices: Optional[int] = None, device: Optional[str] = None,
                 backend: Optional[str] = None) -> DeviceConfig:
    """Join the ``torch.distributed`` run this process was launched into, or stay one
    process when it was launched alone.

    Args:
        num_devices: the ranks the run must have (``None``: as launched). More than one
            without a launcher's environment, or another number than ``WORLD_SIZE``, raises.
        device: ``"cuda"`` (the default) or ``"cpu"``. Each rank takes ``cuda:LOCAL_RANK``,
            or ``cuda:(LOCAL_RANK % device_count)`` over gloo. ``"cuda"`` raises when no GPU
            is visible: the CPU runs only where the caller asks for it.
        backend: ``None`` (NCCL on CUDA, gloo on the CPU) or ``"gloo"`` on CUDA.

    A collective that waits :data:`DEFAULT_TIMEOUT_S` for a rank fails the run.
    """
    device_type = torch.device(device or "cuda").type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"setup_device(..., device='{device or 'cuda'}'): CUDA is not available; pass device='cpu' "
                           f"to run on the CPU")
    launched = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if not launched:
        if num_devices not in (None, 1):
            raise ValueError(f"setup_device: num_devices={num_devices} needs one process a device, started by the "
                             f"launcher: {launch_command(num_devices)}")
        device_config.device = torch.device(device_type)
        return device_config
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if num_devices is not None and int(num_devices) != world:
        raise ValueError(f"setup_device: num_devices={num_devices} but the launcher started WORLD_SIZE={world} "
                         f"ranks; launch as many as the recipe asks: {launch_command(int(num_devices))}")
    if backend is None:  # the group's own backend when one exists, else the device's
        backend = dist.get_backend() if dist.is_initialized() else ("nccl" if device_type == "cuda" else "gloo")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("setup_device: NCCL needs CUDA tensors; the CPU takes backend='gloo'")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"setup_device: backend must be 'nccl' or 'gloo', got {backend!r}")
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if backend == "nccl" and local_world > count:
            raise ValueError(f"setup_device: {local_world} NCCL ranks on this host but {count} GPU(s): NCCL refuses "
                             f"two ranks on one GPU ('Duplicate GPU detected'); launch at most {count}: "
                             f"{launch_command(count)}")
        torch.cuda.set_device(local_rank % count)
        rank_device = torch.device("cuda", local_rank % count)
    else:
        rank_device = torch.device("cpu")

    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_backend() != backend:
            raise RuntimeError(f"setup_device: a process group of {dist.get_world_size()} ranks over "
                               f"{dist.get_backend()} exists already; asked for {world} over {backend}")
    else:
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    device_config.device = rank_device
    note = " (gloo on CUDA, asked for by the caller: ranks may share a GPU)" if backend == "gloo" and device_type == "cuda" else ""
    print(f"setup_device: rank {rank} of world size {world}, backend {backend}, device {rank_device}{note}", flush=True)
    return device_config


def local_batch_slice(global_batch_size: int) -> slice:
    """This rank's contiguous slice of a global batch of ``global_batch_size`` items: rank
    ``r`` of ``W`` takes ``[r * n // W, (r + 1) * n // W)`` (the JAX slice where ``W``
    divides ``n``; a final uneven batch is split with no item left out)."""
    world, rank = get_world_size(), get_rank()
    return slice(rank * global_batch_size // world, (rank + 1) * global_batch_size // world)
