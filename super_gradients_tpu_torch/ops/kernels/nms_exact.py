"""Kernel K1: exact (greedy) NMS keep mask — wrapper and plain version.

Replaces the TPU kernel ``super_gradients_tpu/ops/pallas/nms_kernel.py::
pallas_exact_nms_keep`` (and the XLA loop ``ops/nms.py::_exact_keep_mask``)::

    keep[i] = valid[i] & ~any_{j<i}(keep[j] & IoU(i, j) > t)

over score-sorted boxes. The CUDA kernel (``csrc/nms_exact.cu``) is a blocked bitmask
NMS: one pass writes the pairwise IoU > t bits of the valid boxes in 64-box tiles; a
sweep, one block per image, resolves each tile serially on a register and suppresses
the later tiles in parallel, up to the image's last valid box. :func:`exact_nms_keep`
launches it for CUDA tensors and runs :func:`exact_nms_keep_plain` for CPU tensors;
there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from super_gradients_tpu_torch.ops.bbox import box_iou
from super_gradients_tpu_torch.ops.kernels.build import load_library

# The sweep keeps three K-bit vectors in shared memory (3K/8 bytes, 24 KB at 65536) and
# must stay within the 48 KB a block gets without opting in; the mask scratch is K*K/8
# bytes per image (512 MB at 65536).
MAX_K = 1 << 16
MAX_BATCH = 65535  # gridDim.y of the mask pass


def exact_nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version: ``[B, K, 4]`` boxes, ``[B, K]`` valid -> ``[B, K]`` bool keep."""
    over = box_iou(boxes, boxes) > iou_threshold  # [B, K, K]
    keep = torch.zeros_like(valid)
    for i in range(valid.shape[1]):
        suppressed = (over[:, i, :i] & keep[:, :i]).any(dim=-1)
        keep[:, i] = valid[:, i] & ~suppressed
    return keep


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("nms_exact.cu")
    lib.sg_nms_exact_keep.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.sg_nms_exact_keep.restype = ctypes.c_int
    lib.sg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def exact_nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask.

    Args:
        boxes: ``[B, K, 4]`` float32 xyxy, contiguous, sorted by descending score
            within each image (class-offset for class-aware NMS).
        valid: ``[B, K]`` bool, contiguous, on the same device.
        iou_threshold: a box is suppressed by a kept earlier box when IoU > this.

    Returns ``[B, K]`` bool. CPU tensors take the plain version; CUDA tensors
    launch the kernel (``exact_nms_keep.launches`` counts the launches).
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be [B, K, 4] float32, got {tuple(boxes.shape)} {boxes.dtype}")
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"valid must be bool {tuple(boxes.shape[:2])}, got {tuple(valid.shape)} {valid.dtype}")
    if valid.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device} but valid on {valid.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.device.type == "cpu":
        return exact_nms_keep_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"exact_nms_keep runs on cpu or cuda tensors, got {boxes.device}")

    b, k, _ = boxes.shape
    if k > MAX_K or b > MAX_BATCH:
        raise ValueError(f"exact_nms_keep supports B <= {MAX_BATCH} and K <= {MAX_K}, got B={b}, K={k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    mask = torch.empty((b, (k + 63) // 64, k), dtype=torch.int64, device=boxes.device)
    lib = _library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sg_nms_exact_keep(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), mask.data_ptr(),
            b, k, float(iou_threshold), stream,
        )
    if err != 0:
        raise RuntimeError(f"nms_exact kernel launch failed: {lib.sg_cuda_error_string(err).decode()} ({err})")
    exact_nms_keep.launches += 1
    return keep


exact_nms_keep.launches = 0
