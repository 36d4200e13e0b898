"""Checkpoint directory layout (counterpart of ``super_gradients_tpu/common/environment.py``).

``ckpt_root_dir/<experiment_name>/RUN_<YYYYMMDD_HHMMSS>/``; without a
``ckpt_root_dir`` the root is ``$SG_TPU_HOME`` (default ``~/sg_tpu_checkpoints``),
as in the JAX package.
"""

from __future__ import annotations

import os
import re
import time
from typing import List, Optional

_RUN_DIR_RE = re.compile(r"^RUN_(\d{8}_\d{6})$")


def is_primary_process() -> bool:
    """True unless this is a ``torch.distributed`` process of rank > 0."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


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
