"""bf16 mixed-precision training policy (counterpart of
``super_gradients_tpu/training/mixed_precision.py``).

- Parameters, optimizer state, EMA and BatchNorm running buffers stay fp32.
- The forward (and so the backward) runs under ``torch.autocast(dtype=bfloat16)``:
  convolutions and matrix products compute in bf16, while autocast keeps
  BatchNorm's parameters and statistics in fp32. The JAX policy casts every
  parameter to bf16, BN included; the port accepts that divergence and holds the
  bf16 loss to the fp32 loss only loosely (``tests/test_torch_train_step.py``).
- No gradient scaler: bf16 has fp32's exponent range.
- The model's outputs are cast to fp32 before the criterion, so the assigner,
  IoU and DFL math keep full precision.
"""

from __future__ import annotations

import torch


def autocast(device: torch.device, enabled: bool) -> torch.autocast:
    """The policy's bf16 autocast on ``device`` (a no-op unless ``enabled``)."""
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16, enabled=enabled)


def to_f32(outputs):
    """bf16 tensors of a tensor or a (named) tuple of them -> fp32; the rest as is."""
    if isinstance(outputs, torch.Tensor):
        return outputs.float() if outputs.dtype == torch.bfloat16 else outputs
    if isinstance(outputs, tuple):
        items = [to_f32(o) for o in outputs]
        return type(outputs)(*items) if hasattr(outputs, "_fields") else type(outputs)(items)
    return outputs
