"""SPP max-pool pyramid (counterpart of ``super_gradients_tpu/ops/pooling.py``).

Stride-1 max pooling with -inf padding composes: ``pool9(x) == pool5(pool5(x))``
and ``pool13(x) == pool5(pool5(pool5(x)))``. The (5, 9, 13) pyramid is therefore
three chained 5x5 pools. The JAX module's custom backward exists for the TPU's
slow select-and-scatter and has no counterpart here: torch's ``max_pool2d``
backward already sends each output's gradient to the first max of its window in
row-major order, as that custom backward does (``tests/test_torch_blocks.py`` on
the CPU, ``tests/test_torch_train_cuda.py`` on a GPU).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def chained_max_pools(x: torch.Tensor, ks: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """``[max_pool_k(x) for k in ks]`` for increasing odd ``ks`` (NCHW), each pool
    computed from the previous one."""
    outs = []
    prev = x
    reach = 0  # one-sided radius of `prev` relative to x
    for k in ks:
        radius = k // 2
        step = radius - reach
        if k % 2 != 1 or step <= 0:
            raise ValueError(f"chained_max_pools needs increasing odd kernels, got {tuple(ks)}")
        prev = F.max_pool2d(prev, kernel_size=2 * step + 1, stride=1, padding=step)
        reach = radius
        outs.append(prev)
    return tuple(outs)
