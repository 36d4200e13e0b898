"""Loss registry surface of the port (counterpart of
``super_gradients_tpu/training/losses/__init__.py``; the classification and segmentation
losses, PPYoloELoss, YoloXDetectionLoss, YoloNASPoseLoss and SSDLoss so far; the segmentation
ones include ShelfNet's two, MaskAttentionLoss and the channel-wise distillation loss ``SegKDLoss`` /
``CWDKlDivLoss``; ``KDLogitsLoss``)."""

from super_gradients_tpu_torch.common.registry import LOSSES
from super_gradients_tpu_torch.training.losses.classification_losses import (  # noqa: F401
    CrossEntropyLoss,
    FocalLoss,
    LabelSmoothingCrossEntropyLoss,
    MSELoss,
    RSquaredLoss,
)
from super_gradients_tpu_torch.training.losses.kd_losses import KDLogitsLoss  # noqa: F401
from super_gradients_tpu_torch.training.losses.ppyolo_loss import PPYoloELoss  # noqa: F401
from super_gradients_tpu_torch.training.losses.ssd_loss import SSDLoss  # noqa: F401
from super_gradients_tpu_torch.training.losses.segmentation_losses import (  # noqa: F401
    BCEDiceLoss,
    BinaryDiceLoss,
    ChannelWiseKnowledgeDistillationLoss,
    DiceCEEdgeLoss,
    DiceLoss,
    MaskAttentionLoss,
    OhemCELoss,
    SegCrossEntropyLoss,
    ShelfNetOHEMLoss,
    ShelfNetSemanticEncodingLoss,
    STDCLoss,
)
from super_gradients_tpu_torch.training.losses.yolo_nas_pose_loss import YoloNASPoseLoss  # noqa: F401
from super_gradients_tpu_torch.training.losses.yolox_loss import YoloXDetectionLoss  # noqa: F401


def get_loss(name_or_loss, criterion_params=None):
    """A loss by registry name, built with ``criterion_params``; a callable passes through."""
    if callable(name_or_loss):
        return name_or_loss
    if name_or_loss not in LOSSES:
        raise KeyError(f"Unknown loss `{name_or_loss}`; registered: {sorted(LOSSES)}")
    return LOSSES[name_or_loss](**(criterion_params or {}))
