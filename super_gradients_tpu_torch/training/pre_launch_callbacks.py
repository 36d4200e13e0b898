"""Pre-launch callbacks: recipe changes made before anything is built (counterpart of
``super_gradients_tpu/training/pre_launch_callbacks.py``).

``AutoTrainBatchSizeSelectionCallback`` doubles the train batch from
``min_batch_size`` while one training step fits ``hbm_budget_gb``, and scales the
initial LR linearly with the batch it picks. The JAX package reads each candidate's
memory from XLA's compile-time analysis; here the probe is one real forward and
backward on the model's device, read from ``torch.cuda.max_memory_allocated``.
``Trainer.train_from_config`` resolves the recipe's ``pre_launch_callbacks_list``
entries by name through :data:`PRE_LAUNCH_CALLBACKS`.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, Optional

import torch

from super_gradients_tpu_torch.common.factories import BaseFactory

logger = logging.getLogger(__name__)


def estimate_train_step_memory_gb(model, batch_size: int, image_hw, loss_fn) -> Optional[float]:
    """Peak device memory, in GB, of one fp32 training forward and backward of ``model.net``
    at ``batch_size`` (zero images ``[B, 3, H, W]``, targets ``[B]`` int32 zeros as the JAX
    probe shapes them; ``loss_fn(outputs, targets)`` returns ``(loss, components)``).

    The network's weights and BN statistics are left as they were. None on the CPU, and
    None when the step runs out of device memory."""
    device = model.device
    if device.type != "cuda":
        return None
    net = model.net
    was_training = net.training
    buffers = {name: b.detach().clone() for name, b in net.named_buffers()}
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    try:
        images = torch.zeros((batch_size, 3, *image_hw), device=device)
        targets = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        loss, _ = loss_fn(net.train()(images), targets)
        loss.backward()
        torch.cuda.synchronize(device)
        return torch.cuda.max_memory_allocated(device) / 1e9
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        net.zero_grad(set_to_none=True)
        with torch.no_grad():
            for name, b in net.named_buffers():
                b.copy_(buffers[name])
        net.train(was_training)
        torch.cuda.empty_cache()


class AutoTrainBatchSizeSelectionCallback:
    """Pick the largest batch of ``min_batch_size * 2**k`` (up to ``max_batch_size``) whose
    training step fits ``hbm_budget_gb``, and scale ``initial_lr`` by chosen / recipe batch.
    Without a model and a loss to probe it hands the recipe back unchanged, as the JAX one
    does when the trainer calls it with the recipe alone."""

    def __init__(self, min_batch_size: int = 8, size_step: int = 8, max_batch_size: int = 512,
                 hbm_budget_gb: float = 14.0, scale_lr: bool = True):
        self.min_batch_size = min_batch_size
        self.size_step = size_step
        self.max_batch_size = max_batch_size
        self.hbm_budget_gb = hbm_budget_gb
        self.scale_lr = scale_lr

    def __call__(self, cfg: Dict, model=None, loss_fn=None, image_hw=(224, 224)) -> Dict:
        cfg = copy.deepcopy(cfg)
        if model is None or loss_fn is None:
            return cfg
        chosen = self.min_batch_size
        bs = self.min_batch_size
        while bs <= self.max_batch_size:
            gb = estimate_train_step_memory_gb(model, bs, image_hw, loss_fn)
            if gb is None or gb > self.hbm_budget_gb:
                break
            chosen = bs
            bs *= 2
        base_bs = cfg.get("dataset_params", {}).get("train_dataloader_params", {}).get("batch_size", chosen)
        cfg.setdefault("dataset_params", {}).setdefault("train_dataloader_params", {})["batch_size"] = chosen
        if self.scale_lr and base_bs:
            tp = cfg.setdefault("training_hyperparams", {})
            tp["initial_lr"] = float(tp.get("initial_lr", 0.01)) * chosen / base_bs
        logger.info(f"AutoTrainBatchSizeSelection: batch_size={chosen}")
        return cfg


PRE_LAUNCH_CALLBACKS = {"AutoTrainBatchSizeSelectionCallback": AutoTrainBatchSizeSelectionCallback}
NOT_PORTED = {"QATRecipeModificationCallback": "ROADMAP.md queue 1, item 8, 'Deployment and scale-out' (QAT)"}


def resolve_pre_launch_callback(entry):
    """A recipe entry (a name, ``{name: params}`` or a callable) as a callable over the recipe."""
    return BaseFactory(PRE_LAUNCH_CALLBACKS, NOT_PORTED, kind="pre-launch callback", unknown_error=KeyError).get(entry)
