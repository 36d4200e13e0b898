"""Distribution-focal-loss box decode (counterpart of ``super_gradients_tpu/ops/dfl.py``)."""

from __future__ import annotations

import torch


def dfl_decode(dist_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """``[..., 4, reg_max+1]`` logits -> ``[..., 4]`` expected distances (stride units).

    Softmax and projection run in fp32 whatever the input dtype.
    """
    proj = torch.arange(reg_max + 1, dtype=torch.float32, device=dist_logits.device)
    prob = torch.softmax(dist_logits.float(), dim=-1)
    return prob @ proj
