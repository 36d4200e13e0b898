"""Model export: the fused inference program as a ``torch.export`` artifact (counterpart of
``super_gradients_tpu/conversion/export.py``).

Each exporter builds one ``nn.Module`` program: uint8 NHWC images in, the cast to the
compute type, the model's photometric preprocessing (``Processing.get_equivalent_photometric_fn``,
else ``/ 255``), the deploy-form network and the task's decoding (batched NMS for detection,
pose NMS for pose estimation, an int32 class map for segmentation). It traces the program
with ``torch.export.export`` at a fixed ``[batch_size, H, W, 3]`` and writes it with
``torch.export.save`` (a ``.pt2`` file). Exact NMS stays in the program as the custom op
``sg_torch::nms_exact_keep`` (``ops/kernels/nms_exact.py``): on a GPU the reloaded program
launches kernel K1, on the CPU its plain version.

Outputs, as the JAX programs give them (BATCHED format): :class:`NMSOutput` (boxes
``[B, max_predictions, 4]`` xyxy, scores, labels, ``num_detections`` ``[B]``),
:class:`PoseNMSOutput` (poses ``[B, max_predictions, J, 3]``, boxes, scores,
``num_detections``), or the ``[B, H, W]`` int32 class map. :func:`load_exported` registers
the op and the output types, then loads the artifact; its ``.call(images)`` runs it on the
device the artifact was exported on.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import logging
import os
from typing import Callable, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch import nn

from super_gradients_tpu_torch.ops.nms import NMSOutput, PoseNMSOutput, batched_nms, batched_pose_nms

logger = logging.getLogger(__name__)

_INT8 = "ROADMAP.md queue 1, item 8, 'Deployment and scale-out' (quantization)"


def _register_output_types() -> None:
    """Let ``torch.export`` write and read the programs' namedtuple outputs."""
    for cls in (NMSOutput, PoseNMSOutput):
        if cls not in pytree.SUPPORTED_SERIALIZED_TYPES:
            pytree._register_namedtuple(cls, serialized_type_name=f"{cls.__module__}.{cls.__name__}")


@dataclasses.dataclass
class ExportResult:
    """Where the artifact went, its input, and how to load and run it."""

    output_path: str
    input_shape: Tuple[int, ...]
    input_dtype: str
    usage_instructions: str

    def __repr__(self):
        return self.usage_instructions


def _photometric_fn(model, preprocessing: bool) -> Optional[Callable]:
    """The in-program preprocessing: the model's processing's photometric steps, else ``/ 255``;
    None without ``preprocessing``."""
    if not preprocessing:
        return None
    proc = model.get_processing_params() if hasattr(model, "get_processing_params") else None
    fn = proc.get_equivalent_photometric_fn() if proc is not None else None
    return fn if fn is not None else (lambda x: x / 255.0)


class _Program(nn.Module):
    """images ``[B, H, W, 3]`` -> cast -> photometric -> cast -> ``net`` (NCHW) -> ``decode``."""

    def __init__(self, net: nn.Module, in_dtype: torch.dtype, photometric: Optional[Callable], decode: Callable):
        super().__init__()
        self.net = net
        self.in_dtype = in_dtype
        self.photometric = photometric
        self.decode = decode

    def forward(self, images: torch.Tensor):
        x = images.to(self.in_dtype)
        if self.photometric is not None:
            x = self.photometric(x).to(self.in_dtype)
        # an NHWC tensor permuted to NCHW is in channels_last memory order, as the deploy net on a GPU
        return self.decode(self.net(x.permute(0, 3, 1, 2)))


def _export(model, program: _Program, output_path: str, batch_size: int, image_hw, preprocessing: bool):
    """Trace ``program`` at the fixed input shape and write it; returns (shape, dtype, MB)."""
    _register_output_types()
    dtype = torch.uint8 if preprocessing else torch.float32
    shape = (batch_size, int(image_hw[0]), int(image_hw[1]), 3)
    example = torch.zeros(shape, dtype=dtype, device=model.device)
    if any(t.is_inference() for t in itertools.chain(program.parameters(), program.buffers())):
        program.net = copy.deepcopy(program.net)  # a deploy net built under predict()'s inference mode
    with torch.inference_mode(False):
        exported = torch.export.export(program.eval(), (example,))
    os.makedirs(os.path.dirname(os.path.abspath(output_path)) or ".", exist_ok=True)
    torch.export.save(exported, output_path)
    return shape, str(dtype).replace("torch.", ""), os.path.getsize(output_path) / 1e6


def _usage(kind: str, output_path: str, shape, megabytes: float, outputs: str) -> str:
    return (
        f"Exported fused {kind} program to {output_path} ({megabytes:.1f} MB).\n"
        f"Input: uint8 [{shape[0]}, {shape[1]}, {shape[2]}, 3] (RGB, 0-255).\n"
        "Load and run:\n"
        "    from super_gradients_tpu_torch.conversion.export import load_exported\n"
        f"    exported = load_exported({output_path!r})\n"
        f"    {outputs}"
    )


def export_detection_model(
    model,
    output_path: str,
    batch_size: int = 1,
    image_hw: Optional[Tuple[int, int]] = None,
    confidence_threshold: float = 0.25,
    nms_threshold: float = 0.7,
    nms_top_k: int = 1024,
    max_predictions: int = 300,
    fuse_model: bool = True,
    bf16: bool = True,
    nms_mode: str = "exact",
    preprocessing: bool = True,
    quantization_mode: Optional[str] = None,
    calibration_table=None,
) -> ExportResult:
    """Export the fused predict program of a :class:`DetectionModel`: the deploy net
    (``fuse_model``, ``bf16``) and ``batched_nms`` with the live predict's NMS input (the
    logits of ``YoloNASOutputs``, every other head's score map). ``quantization_mode="int8"``
    is not ported yet and raises ``NotImplementedError``."""
    from super_gradients_tpu_torch.models.detection.yolo_nas import YoloNASOutputs

    if getattr(model, "task", None) != "detection" or not hasattr(model, "_deploy_net"):
        raise TypeError(f"export_detection_model requires a DetectionModel; got task `{getattr(model, 'task', '?')}`")
    if quantization_mode not in (None, "int8"):
        raise ValueError(f"quantization_mode must be None or 'int8', got {quantization_mode!r}")
    if quantization_mode == "int8":
        raise NotImplementedError(f"int8 export is not ported yet ({_INT8})")
    image_hw = image_hw or model._input_hw

    def decode(out):
        use_logits = isinstance(out, YoloNASOutputs)
        return batched_nms(
            out.pred_bboxes, out.cls_logits if use_logits else out.pred_scores, score_threshold=confidence_threshold,
            iou_threshold=nms_threshold, nms_top_k=nms_top_k, max_predictions=max_predictions, mode=nms_mode,
            scores_are_logits=use_logits,
        )

    program = _Program(model._deploy_net(fuse_model, bf16), torch.bfloat16 if bf16 else torch.float32,
                       _photometric_fn(model, preprocessing), decode)
    shape, dtype, mb = _export(model, program, output_path, batch_size, image_hw, preprocessing)
    usage = _usage("detection", output_path, shape, mb, "boxes, scores, labels, num_det = exported.call(images)\n"
                   f"Outputs (BATCHED format): boxes [{batch_size}, {max_predictions}, 4] xyxy, "
                   f"scores/labels [{batch_size}, {max_predictions}], num_detections [{batch_size}].")
    logger.info(usage.splitlines()[0])
    return ExportResult(output_path, shape, dtype, usage)


def export_pose_estimation_model(
    model,
    output_path: str,
    batch_size: int = 1,
    image_hw: Optional[Tuple[int, int]] = None,
    confidence_threshold: float = 0.5,
    nms_threshold: float = 0.7,
    nms_top_k: int = 1024,
    max_predictions: int = 30,
    bf16: bool = True,
    nms_mode: str = "exact",
    preprocessing: bool = True,
) -> ExportResult:
    """Export the fused pose predict program: the unfused net (``bf16``), its outputs in fp32,
    ``batched_pose_nms``."""
    if getattr(model, "task", None) != "pose_estimation":
        raise TypeError(f"export_pose_estimation_model requires a pose model; got task `{getattr(model, 'task', '?')}`")
    image_hw = image_hw or model._input_hw

    def decode(out):
        return batched_pose_nms(
            out.pred_bboxes.float(), out.pred_scores.float(), out.pred_pose_coords.float(),
            out.pred_pose_scores.float(), score_threshold=confidence_threshold, iou_threshold=nms_threshold,
            nms_top_k=nms_top_k, max_predictions=max_predictions, mode=nms_mode,
        )

    program = _Program(model._deploy_net(False, bf16), torch.bfloat16 if bf16 else torch.float32,
                       _photometric_fn(model, preprocessing), decode)
    shape, dtype, mb = _export(model, program, output_path, batch_size, image_hw, preprocessing)
    usage = _usage("pose-estimation", output_path, shape, mb, "poses, boxes, scores, num_det = exported.call(images)\n"
                   f"Outputs: poses [{batch_size}, {max_predictions}, K, 3], boxes [..., 4], scores, num_detections.")
    logger.info(usage.splitlines()[0])
    return ExportResult(output_path, shape, dtype, usage)


def export_segmentation_model(
    model,
    output_path: str,
    batch_size: int = 1,
    image_hw: Optional[Tuple[int, int]] = None,
    confidence_threshold: float = 0.5,
    bf16: bool = True,
    preprocessing: bool = True,
) -> ExportResult:
    """Export the fused segmentation program: the net (``bf16``), the first map of a tuple
    output in fp32, then the argmax over classes, or ``sigmoid > confidence_threshold`` for
    one class, as an int32 ``[B, H, W]`` class map."""
    if getattr(model, "task", None) != "segmentation":
        raise TypeError(f"export_segmentation_model requires a segmentation model; got task `{getattr(model, 'task', '?')}`")
    image_hw = image_hw or model._input_hw
    binary = model.num_classes == 1

    def decode(logits):
        if isinstance(logits, (tuple, list)):
            logits = logits[0]
        logits = logits.float()
        if binary:
            return (torch.sigmoid(logits[:, 0]) > confidence_threshold).to(torch.int32)
        return logits.argmax(dim=1).to(torch.int32)

    program = _Program(model._deploy_net(False, bf16), torch.bfloat16 if bf16 else torch.float32,
                       _photometric_fn(model, preprocessing), decode)
    shape, dtype, mb = _export(model, program, output_path, batch_size, image_hw, preprocessing)
    usage = _usage("segmentation", output_path, shape, mb, "class_map = exported.call(images)\n"
                   f"Outputs: class map int32 [{batch_size}, H, W].")
    logger.info(usage.splitlines()[0])
    return ExportResult(output_path, shape, dtype, usage)


class ExportedProgram:
    """A loaded artifact: ``.call(images)`` runs it on the device it was exported on;
    ``.program`` is the ``torch.export.ExportedProgram``."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self._module = program.module()
        tensors = list(program.state_dict.values()) + list(program.constants.values())
        self.device = tensors[0].device if tensors else torch.device("cpu")

    @torch.inference_mode()
    def call(self, images):
        return self._module(torch.as_tensor(images).to(self.device))


def load_exported(path: str) -> ExportedProgram:
    """Load an artifact of the exporters above: the NMS op is registered first (importing
    ``ops/kernels/nms_exact.py``), and so are the output types."""
    import super_gradients_tpu_torch.ops.kernels.nms_exact  # noqa: F401  (registers sg_torch::nms_exact_keep)

    _register_output_types()
    return ExportedProgram(torch.export.load(path))
