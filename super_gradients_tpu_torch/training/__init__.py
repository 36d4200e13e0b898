"""Training slice of the port (counterpart of ``super_gradients_tpu/training``):
``Trainer.train`` with the classification and segmentation losses, PPYoloELoss or
YoloNASPoseLoss, SGD/Adam/AdamW, LR schedules, EMA and the bf16 policy, fed by
``torch.utils.data.DataLoader``."""

from super_gradients_tpu_torch.training.dataloaders import (
    RandomClassificationDataset,
    RandomDetectionDataset,
    RandomSegmentationDataset,
)
from super_gradients_tpu_torch.training.trainer import Trainer

__all__ = ["RandomClassificationDataset", "RandomDetectionDataset", "RandomSegmentationDataset", "Trainer"]
