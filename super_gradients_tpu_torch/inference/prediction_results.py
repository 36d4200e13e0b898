"""Prediction result objects (counterpart of ``super_gradients_tpu/inference/prediction_results.py``).

A :class:`DetectionPrediction` draws its boxes and labels on its image with PIL (imported
at the call), in the JAX package's colours, text and layout; :class:`ImagesPredictions`
saves every image's drawing, :class:`VideoPredictions` writes them as a video.
Classification, segmentation and pose predictions come with their model families.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

_PALETTE = [
    (255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29), (207, 210, 49),
    (72, 249, 10), (146, 204, 23), (61, 219, 134), (26, 147, 52), (0, 212, 187),
    (44, 153, 168), (0, 194, 255), (52, 69, 147), (100, 115, 255), (0, 24, 236),
    (132, 56, 255), (82, 0, 133), (203, 56, 255), (255, 149, 200), (255, 55, 199),
]


@dataclasses.dataclass
class DetectionPrediction:
    """Per-image detection result in original-image coordinates."""

    bboxes_xyxy: np.ndarray  # [N, 4]
    confidence: np.ndarray  # [N]
    labels: np.ndarray  # [N] int
    class_names: Optional[List[str]] = None
    image: Optional[np.ndarray] = None  # HWC RGB uint8

    def __len__(self):
        return len(self.confidence)

    def draw(self, box_thickness: int = 2, show_confidence: bool = True) -> np.ndarray:
        """The image with each box outlined in its label's colour and ``name score`` above it."""
        from PIL import Image, ImageDraw

        img = Image.fromarray(self.image.copy())
        d = ImageDraw.Draw(img)
        for box, conf, label in zip(self.bboxes_xyxy, self.confidence, self.labels):
            color = _PALETTE[int(label) % len(_PALETTE)]
            d.rectangle([float(box[0]), float(box[1]), float(box[2]), float(box[3])], outline=color, width=box_thickness)
            name = self.class_names[int(label)] if self.class_names else str(int(label))
            text = f"{name} {conf:.2f}" if show_confidence else name
            d.text((float(box[0]) + 2, max(0.0, float(box[1]) - 12)), text, fill=color)
        return np.asarray(img)

    def save(self, output_path: str, **kwargs) -> None:
        from PIL import Image

        Image.fromarray(self.draw(**kwargs)).save(output_path)

    def show(self, **kwargs) -> np.ndarray:
        """The drawing (there is no display to show it on a server)."""
        return self.draw(**kwargs)


class ImagesPredictions:
    """Container over per-image predictions."""

    def __init__(self, predictions: List):
        self._images_prediction_lst = predictions

    def __len__(self):
        return len(self._images_prediction_lst)

    def __getitem__(self, i):
        return self._images_prediction_lst[i]

    def __iter__(self):
        return iter(self._images_prediction_lst)

    def save(self, output_folder: str, **kwargs) -> None:
        """Each image's drawing as ``<output_folder>/pred_<i>.jpg``."""
        os.makedirs(output_folder, exist_ok=True)
        for i, p in enumerate(self._images_prediction_lst):
            p.save(os.path.join(output_folder, f"pred_{i}.jpg"), **kwargs)


class VideoPredictions(ImagesPredictions):
    """Per-frame predictions of a video: ``draw()`` gives the drawn frames, ``save(path)``
    writes them as an MP4 / AVI / GIF at the source frame rate."""

    def __init__(self, predictions: List, fps: int):
        super().__init__(predictions)
        self.fps = fps

    def draw(self, **kwargs) -> List[np.ndarray]:
        return [p.draw(**kwargs) for p in self._images_prediction_lst]

    def save(self, output_path: str, **kwargs) -> None:
        from super_gradients_tpu_torch.inference.video import save_video

        save_video(output_path, self.draw(**kwargs), self.fps)
