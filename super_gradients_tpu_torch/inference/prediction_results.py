"""Prediction result objects (counterpart of ``super_gradients_tpu/inference/prediction_results.py``).

A :class:`DetectionPrediction` draws its boxes and labels on its image with PIL (imported
at the call), in the JAX package's colours, text and layout, and a
:class:`PoseEstimationPrediction` its skeletons; :class:`ImagesPredictions` saves every
image's drawing, :class:`VideoPredictions` writes them as a video. A
:class:`ClassificationPrediction` holds the top-k labels and their probabilities; it has
no drawing, as in the JAX package. A :class:`SegmentationPrediction` holds a class map
and draws it over its image, one palette colour a class.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

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


@dataclasses.dataclass
class ClassificationPrediction:
    """Per-image classification result: the top-k labels, most probable first."""

    confidence: np.ndarray  # [k] softmax probabilities
    labels: np.ndarray  # [k] int
    class_names: Optional[List[str]] = None
    image: Optional[np.ndarray] = None  # HWC RGB uint8

    @property
    def prediction(self) -> int:
        return int(self.labels[0])


@dataclasses.dataclass
class SegmentationPrediction:
    """Per-image segmentation result: a class id a pixel at the image's size."""

    segmentation_map: np.ndarray  # [H, W] int class ids
    class_names: Optional[List[str]] = None
    image: Optional[np.ndarray] = None  # HWC RGB uint8

    def draw(self, alpha: float = 0.5) -> np.ndarray:
        """The image blended with the class colours, ``image * (1 - alpha) + colour * alpha``
        truncated to uint8 (a black image where there is none)."""
        overlay = np.zeros((*self.segmentation_map.shape, 3), dtype=np.uint8)
        for cls in np.unique(self.segmentation_map):
            overlay[self.segmentation_map == cls] = _PALETTE[int(cls) % len(_PALETTE)]
        base = self.image if self.image is not None else np.zeros_like(overlay)
        return (base * (1 - alpha) + overlay * alpha).astype(np.uint8)

    def save(self, output_path: str, **kwargs) -> None:
        from PIL import Image

        Image.fromarray(self.draw(**kwargs)).save(output_path)


@dataclasses.dataclass
class PoseEstimationPrediction:
    """Per-image pose result in original-image coordinates."""

    poses: np.ndarray  # [N, J, 3] x, y, joint score
    scores: np.ndarray  # [N]
    bboxes_xyxy: Optional[np.ndarray] = None  # [N, 4]
    edge_links: Optional[Sequence] = None  # joint pairs of the skeleton
    edge_colors: Optional[Sequence] = None  # RGB a link
    keypoint_colors: Optional[Sequence] = None  # RGB a joint
    image: Optional[np.ndarray] = None  # HWC RGB uint8

    def __len__(self):
        return len(self.scores)

    def draw(self, keypoint_radius: int = 3) -> np.ndarray:
        """The image with each pose's links (both joints scored above 0) and joints, in
        the pose's palette colour unless link and joint colours are given."""
        from PIL import Image, ImageDraw

        img = Image.fromarray(self.image.copy())
        d = ImageDraw.Draw(img)
        for pose_i, pose in enumerate(self.poses):
            color = _PALETTE[pose_i % len(_PALETTE)]
            if self.edge_links is not None:
                for link_i, (a, b) in enumerate(self.edge_links):
                    if pose[a, 2] > 0 and pose[b, 2] > 0:
                        ec = tuple(self.edge_colors[link_i]) if self.edge_colors is not None else color
                        d.line([tuple(pose[a, :2]), tuple(pose[b, :2])], fill=ec, width=2)
            for joint_i, (x, y, v) in enumerate(pose):
                if v > 0:
                    kc = tuple(self.keypoint_colors[joint_i]) if self.keypoint_colors is not None else color
                    d.ellipse([x - keypoint_radius, y - keypoint_radius, x + keypoint_radius, y + keypoint_radius],
                              fill=kc)
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
