"""Data parallelism across GPUs (counterpart of ``super_gradients_tpu/parallel``):
``setup_device``, the collectives and the global-batch BatchNorm. The JAX package's
tensor and spatial sharding (``parallel/tensor.py``, ``parallel/spatial.py``) are not
ported (ROADMAP.md queue 1, item 8)."""

from super_gradients_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather_from_hosts,
    all_gather_variable_length,
    broadcast_from_primary,
    global_sum,
    is_distributed,
    maybe_pmean_across_hosts,
)
from super_gradients_tpu_torch.parallel.mesh import DeviceConfig, device_config, local_batch_slice, setup_device  # noqa: F401
from super_gradients_tpu_torch.parallel.sync_batch_norm import GlobalBatchNorm2d, convert_batch_norm  # noqa: F401
