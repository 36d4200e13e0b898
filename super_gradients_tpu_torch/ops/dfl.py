"""Distribution-focal-loss box decode (counterpart of ``super_gradients_tpu/ops/dfl.py``)."""

from __future__ import annotations

import torch


def dfl_decode(dist_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """``[..., 4, reg_max+1]`` logits -> ``[..., 4]`` expected distances (stride units).

    Softmax and projection run in fp32 for fp32 and narrower inputs, in fp64 for fp64.
    """
    logits = dist_logits if dist_logits.dtype == torch.float64 else dist_logits.float()
    proj = torch.arange(reg_max + 1, dtype=logits.dtype, device=dist_logits.device)
    return torch.softmax(logits, dim=-1) @ proj
