"""Architecture registrations of the port (the YOLO-NAS rows of
``super_gradients_tpu/models/all_models.py``)."""

from __future__ import annotations

import dataclasses

from super_gradients_tpu_torch.common.registry import register_model
from super_gradients_tpu_torch.inference.processing import default_yolo_nas_coco_processing
from super_gradients_tpu_torch.models.class_names import COCO_DETECTION_CLASSES_LIST
from super_gradients_tpu_torch.models.detection.yolo_nas import (
    YoloNAS,
    yolo_nas_l_config,
    yolo_nas_m_config,
    yolo_nas_config_from_arch_params,
    yolo_nas_s_config,
)
from super_gradients_tpu_torch.models.model_factory import ModelSpec

_FUSED = {"none": False, "full": True}  # the JAX package's `fused` values that the port builds


def _yolo_nas_spec(config_fn, num_classes=None, arch_params=None, image_size: int = 640) -> ModelSpec:
    """The variant's config, or the one an arch_params module-spec tree describes
    (``common/config.py::load_arch_params``)."""
    arch_params = arch_params or {}
    nc = num_classes or arch_params.get("num_classes", 80)
    fused = _FUSED[arch_params.get("fused", "none")]
    if "backbone" in arch_params:
        cfg = dataclasses.replace(yolo_nas_config_from_arch_params(arch_params, nc), fused=fused)
    else:
        cfg = config_fn(num_classes=nc, fused=fused)
    return ModelSpec(
        net=YoloNAS(cfg),
        num_classes=nc,
        input_hw=(image_size, image_size),
        config=cfg,
        processing=default_yolo_nas_coco_processing(image_size),
        class_names=COCO_DETECTION_CLASSES_LIST if nc == 80 else None,
    )


@register_model("yolo_nas_s")
def yolo_nas_s(**kw):
    return _yolo_nas_spec(yolo_nas_s_config, **kw)


@register_model("yolo_nas_m")
def yolo_nas_m(**kw):
    return _yolo_nas_spec(yolo_nas_m_config, **kw)


@register_model("yolo_nas_l")
def yolo_nas_l(**kw):
    return _yolo_nas_spec(yolo_nas_l_config, **kw)
