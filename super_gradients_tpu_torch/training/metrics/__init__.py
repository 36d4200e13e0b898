"""Metrics of the port (counterpart of ``super_gradients_tpu/training/metrics/__init__.py``;
the classification, detection, pose and segmentation metrics so far)."""

from super_gradients_tpu_torch.common.factories import BaseFactory
from super_gradients_tpu_torch.common.registry import METRICS
from super_gradients_tpu_torch.training.metrics.base import Metric, MetricCollection, to_host  # noqa: F401
from super_gradients_tpu_torch.training.metrics.classification import (  # noqa: F401
    Accuracy,
    Top5,
    ToyTestClassificationMetric,
)
from super_gradients_tpu_torch.training.metrics.detection import (  # noqa: F401
    DetectionMetrics,
    DetectionMetrics_050,
    DetectionMetrics_050_095,
    DetectionMetrics_075,
    DetectionMetricsDistanceBased,
)
from super_gradients_tpu_torch.training.metrics.pose_estimation import PoseEstimationMetrics  # noqa: F401
from super_gradients_tpu_torch.training.metrics.segmentation import (  # noqa: F401
    BinaryDice,
    BinaryIoU,
    Dice,
    IoU,
    PixelAccuracy,
)

_BREADTH = "ROADMAP.md queue 1, 'Breadth'"
# registered in the JAX package, not here yet
NOT_PORTED = {
    **dict.fromkeys(("DeltaMetric", "DepthMAE", "DepthMSE", "DepthRMSE"), _BREADTH + " (depth)"),
}


def get_metric(name_or_metric):
    """A metric from a registry name, a ``{name: params}`` dict, or an instance (as is)."""
    if isinstance(name_or_metric, (str, dict)):
        return BaseFactory(METRICS, NOT_PORTED, kind="metric").get(name_or_metric)
    return name_or_metric
