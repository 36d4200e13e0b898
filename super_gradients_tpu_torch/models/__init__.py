"""The port's model zoo: ``models.get(name, num_classes=..., seed=..., device=...)``."""

from super_gradients_tpu_torch.models import all_models  # noqa: F401  (registers the architectures)
from super_gradients_tpu_torch.models.model_factory import get
from super_gradients_tpu_torch.models.sg_model import (
    ClassificationModel,
    DetectionModel,
    PoseEstimationModel,
    SegmentationModel,
    SgModel,
)

__all__ = ["get", "ClassificationModel", "DetectionModel", "PoseEstimationModel", "SegmentationModel", "SgModel"]
