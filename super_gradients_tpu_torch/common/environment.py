"""Checkpoint directory layout (counterpart of ``super_gradients_tpu/common/environment.py``)
and this process's place in a ``torch.distributed`` run.

``ckpt_root_dir/<experiment_name>/RUN_<YYYYMMDD_HHMMSS>/``; without a
``ckpt_root_dir`` the root is ``$SG_TPU_HOME`` (default ``~/sg_tpu_checkpoints``),
as in the JAX package. Without a process group this process is rank 0 of 1.
"""

from __future__ import annotations

import os
import re
import time
from typing import List, Optional

_RUN_DIR_RE = re.compile(r"^RUN_(\d{8}_\d{6})$")


def process_group_active() -> bool:
    """True inside a ``torch.distributed`` process group (of any size, one included)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """This process's rank in the process group; 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if process_group_active() else 0


def get_world_size() -> int:
    """The number of ranks in the process group; 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if process_group_active() else 1


def is_primary_process() -> bool:
    """True unless this is a ``torch.distributed`` process of rank > 0."""
    return get_rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op in one process): a write by rank 0 is done for all."""
    import torch.distributed as dist

    if process_group_active():
        dist.barrier()


def checkpoints_home() -> str:
    return os.getenv("SG_TPU_HOME", os.path.expanduser("~/sg_tpu_checkpoints"))


def generate_run_id() -> str:
    """``RUN_<YYYYMMDD_HHMMSS>`` run-dir name."""
    return "RUN_" + time.strftime("%Y%m%d_%H%M%S")


def get_checkpoints_dir_path(experiment_name: str, ckpt_root_dir: Optional[str] = None, run_id: Optional[str] = None) -> str:
    path = os.path.join(ckpt_root_dir or checkpoints_home(), experiment_name)
    return os.path.join(path, run_id) if run_id else path


def list_run_ids(experiment_name: str, ckpt_root_dir: Optional[str] = None) -> List[str]:
    exp_dir = get_checkpoints_dir_path(experiment_name, ckpt_root_dir)
    if not os.path.isdir(exp_dir):
        return []
    return sorted(d for d in os.listdir(exp_dir) if _RUN_DIR_RE.match(d))


def get_latest_run_id(experiment_name: str, ckpt_root_dir: Optional[str] = None) -> Optional[str]:
    runs = list_run_ids(experiment_name, ckpt_root_dir)
    return runs[-1] if runs else None
