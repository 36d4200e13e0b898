"""Sliding-window (tiled) detection inference (counterpart of
``super_gradients_tpu/inference/sliding_window.py``).

The image is cut into tiles of a fixed grid (:func:`compute_tile_origins`), every tile of
one image goes through one batched forward of the model's deploy form (fused, bf16 as
asked, channels_last on a GPU), the boxes are shifted back to image pixels, and one
``batched_nms`` over the ``T * A`` anchors of all tiles merges them: on a GPU its exact
mode is one launch of kernel K1 an image. As in JAX, the NMS suppresses on
``pred_scores`` (not on logits, even for YOLO-NAS) with 1024 candidates, ``predict``
divides by 255 without a letterbox, and the wrapper defines no ``__call__``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from super_gradients_tpu_torch.inference.media import images_to_list
from super_gradients_tpu_torch.inference.prediction_results import DetectionPrediction, ImagesPredictions
from super_gradients_tpu_torch.ops.nms import NMSOutput, batched_nms


def compute_tile_origins(image_hw: Tuple[int, int], tile_hw: Tuple[int, int],
                         step_hw: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Static tile grid covering the image (last tile clamped to the border), ``(y, x)`` each."""
    H, W = image_hw
    th, tw = tile_hw
    sh, sw = step_hw
    ys = list(range(0, max(H - th, 0) + 1, sh)) or [0]
    xs = list(range(0, max(W - tw, 0) + 1, sw)) or [0]
    if ys[-1] + th < H:
        ys.append(H - th)
    if xs[-1] + tw < W:
        xs.append(W - tw)
    return [(y, x) for y in ys for x in xs]


class SlidingWindowInferenceDetectionWrapper:
    """Tiled detection over large images with a :class:`DetectionModel`."""

    def __init__(
        self,
        model,
        tile_size: int = 640,
        tile_step: int = 512,
        tile_nms_conf: float = 0.25,
        tile_nms_iou: float = 0.7,
        max_predictions: int = 300,
        nms_mode: str = "exact",
    ):
        self.model = model
        self.tile_size = tile_size
        self.tile_step = tile_step
        self.conf = tile_nms_conf
        self.iou = tile_nms_iou
        self.max_predictions = max_predictions
        self.nms_mode = nms_mode

    @torch.inference_mode()
    def predict_image_tensor(self, image, bf16: bool = True) -> NMSOutput:
        """image: ``[H, W, 3]`` float, standardized to the model's expected range."""
        image = torch.as_tensor(image)
        h, w = int(image.shape[0]), int(image.shape[1])
        ts = self.tile_size
        origins = compute_tile_origins((h, w), (ts, ts), (self.tile_step, self.tile_step))
        net = self.model._deploy_net(fuse_model=True, bf16=bf16)
        device = self.model.device
        image = image.to(device, torch.bfloat16 if bf16 else torch.float32)
        tiles = torch.stack([image[y:y + ts, x:x + ts] for y, x in origins])  # [T, ts, ts, 3]
        out = net(tiles.permute(0, 3, 1, 2))  # NHWC permuted: channels_last memory order
        shift = torch.tensor([[x, y, x, y] for y, x in origins], dtype=torch.float32, device=device)
        boxes = out.pred_bboxes.float() + shift[:, None, :]  # [T, A, 4] in image pixels
        scores = out.pred_scores.float()
        t, a, _ = boxes.shape
        return batched_nms(
            boxes.reshape(1, t * a, 4), scores.reshape(1, t * a, scores.shape[-1]), score_threshold=self.conf,
            iou_threshold=self.iou, nms_top_k=1024, max_predictions=self.max_predictions, mode=self.nms_mode,
        )

    def predict(self, images, conf: Optional[float] = None, **kwargs) -> ImagesPredictions:
        """Full-image predict over inputs of any size (``conf`` is not used, as in JAX)."""
        preds = []
        for img in images_to_list(images):
            x = torch.from_numpy(np.asarray(img, dtype=np.float32)) / 255.0
            out = self.predict_image_tensor(x)
            n = int(out.num_detections[0])
            preds.append(DetectionPrediction(
                bboxes_xyxy=out.boxes[0, :n].cpu().numpy(),
                confidence=out.scores[0, :n].cpu().numpy(),
                labels=out.labels[0, :n].cpu().numpy(),
                class_names=self.model.class_names,
                image=img,
            ))
        return ImagesPredictions(preds)
