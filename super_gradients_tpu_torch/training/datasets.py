"""Detection datasets (counterpart of ``super_gradients_tpu/training/datasets.py``).

A sample leaves the dataset as ``(image [3, H, W], targets [max_boxes, 5])``
(cls, x1, y1, x2, y2; ``-1`` rows pad), or ``[max_boxes, 6]`` with an is-crowd
column when ``with_crowd``. When the transform chain ends in ``DetectionStandardize``
that step is skipped: the image is uint8, ``max_value`` says what to divide it by,
and the trainer standardizes it on the device (a quarter of the bytes cross to the
card). Otherwise the image is float32, as the JAX chain leaves it.

Randomness: each dataset owns one ``random.Random`` (the transforms' draws) and one
``np.random.RandomState`` (the indices of mosaic and mixup's additional samples),
seeded with ``seed``; DataLoader workers reseed both from their worker seed. For the
same seed a dataset draws what the JAX dataset draws from the global ``random`` and
``np.random``.

Image files are read through PIL, imported where a file is read, so that the module
imports without it.
"""

from __future__ import annotations

import json
import logging
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from super_gradients_tpu_torch.inference.processing import (
    ComposeProcessing,
    DetectionBottomRightPadding,
    DetectionLongestMaxSizeRescale,
    StandardizeImage,
)
from super_gradients_tpu_torch.training.transforms.detection import ComposeDetectionTransforms, DetectionSample

logger = logging.getLogger(__name__)

_IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading an image file needs PIL (Pillow), which is not installed") from e
    return Image


def load_image(path: str) -> np.ndarray:
    """An image file as ``[H, W, 3]`` uint8 RGB (PIL's ``convert("RGB")``)."""
    with _pil_image().open(path) as im:
        return np.asarray(im.convert("RGB"))


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of an image file, from its header (PIL reads no pixels for it)."""
    with _pil_image().open(path) as im:
        return im.size


class DetectionDataset:
    """Base detection dataset.

    Subclasses fill ``self._annotations`` in ``_setup()`` with dicts of ``img_path`` (or
    ``image``), ``boxes_xyxy``, ``labels`` and optionally ``is_crowd``; this base runs
    the transform chain (with the additional samples of mosaic and mixup), filters
    classes and pads the targets.
    """

    def __init__(
        self,
        transforms: Optional[Sequence] = None,
        max_boxes: int = 50,
        class_inclusion_list: Optional[Sequence[str]] = None,
        ignore_empty_annotations: bool = False,
        all_classes_list: Optional[Sequence[str]] = None,
        cache_images: bool = False,
        with_crowd: bool = False,
        seed: int = 0,
    ):
        self.transforms = ComposeDetectionTransforms(transforms or [])
        trailing = self.transforms.trailing_standardize
        self.max_value: Optional[float] = trailing.max_value if trailing is not None else None
        self.max_boxes = max_boxes
        self.all_classes_list = list(all_classes_list or [])
        self.class_inclusion_list = list(class_inclusion_list) if class_inclusion_list else None
        self.ignore_empty_annotations = ignore_empty_annotations
        self.cache_images = cache_images
        self.with_crowd = with_crowd
        self.rng = random.Random()
        self.np_rng = np.random.RandomState()
        self.reseed(seed)
        self._image_cache: Dict[int, np.ndarray] = {}
        self._annotations: List[Dict] = []
        self._setup()
        if self.class_inclusion_list:
            keep_ids = {self.all_classes_list.index(c) for c in self.class_inclusion_list}
            remap = {old: new for new, old in enumerate(sorted(keep_ids))}
            filtered = []
            for ann in self._annotations:
                mask = np.isin(ann["labels"], list(keep_ids))
                ann = dict(ann, boxes_xyxy=ann["boxes_xyxy"][mask], labels=np.asarray([remap[int(l)] for l in ann["labels"][mask]], np.int32))
                if ann.get("is_crowd") is not None and len(ann["is_crowd"]) == len(mask):
                    ann["is_crowd"] = np.asarray(ann["is_crowd"])[mask]
                filtered.append(ann)
            self._annotations = filtered
            self.classes = list(self.class_inclusion_list)
        else:
            self.classes = list(self.all_classes_list)
        if self.ignore_empty_annotations:
            self._annotations = [a for a in self._annotations if len(a["labels"]) > 0]

    def _setup(self):
        raise NotImplementedError

    def reseed(self, seed: int) -> None:
        """Seed both of the dataset's generators (a DataLoader worker calls it with its own seed)."""
        self.rng.seed(seed)
        self.np_rng.seed(seed % 2**32)

    def __len__(self):
        return len(self._annotations)

    def _get_sample(self, index: int) -> DetectionSample:
        ann = self._annotations[index]
        if "img_path" in ann:
            if self.cache_images:
                if index not in self._image_cache:
                    self._image_cache[index] = load_image(ann["img_path"])
                image = self._image_cache[index]
            else:
                image = load_image(ann["img_path"])
        else:
            image = ann["image"]
        crowd = ann.get("is_crowd")
        return DetectionSample(
            image,
            ann["boxes_xyxy"].astype(np.float32),
            ann["labels"].astype(np.int32),
            np.asarray(crowd, bool) if crowd is not None else None,
        )

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        sample = self._get_sample(index)
        n_extra = self.transforms.additional_samples_count
        additional = [self._get_sample(self.np_rng.randint(len(self))) for _ in range(n_extra)]
        sample = self.transforms(sample, self.rng, additional, skip_trailing_standardize=True)
        if self.max_value is not None:
            if sample.image.dtype != np.uint8:
                raise TypeError(f"the chain before its trailing DetectionStandardize left a {sample.image.dtype} "
                                f"image; a dataset ships uint8 images for the device to standardize")
            image = sample.image
        else:
            image = np.asarray(sample.image, dtype=np.float32)
        cols = 6 if self.with_crowd else 5
        target = np.full((self.max_boxes, cols), -1.0, dtype=np.float32)
        n = min(len(sample.labels), self.max_boxes)
        if n:
            target[:n, 0] = sample.labels[:n]
            target[:n, 1:5] = sample.bboxes_xyxy[:n]
            if self.with_crowd:
                crowd = sample.is_crowd[:n] if sample.is_crowd is not None else np.zeros(n, bool)
                target[:n, 5] = crowd.astype(np.float32)
        if self.with_crowd:
            target[n:, 5] = 0.0  # padding rows are never crowd
        return np.ascontiguousarray(image.transpose(2, 0, 1)), target

    def get_dataset_preprocessing_params(self) -> Dict:
        """Predict-ready parameters from the chain's letterbox geometry: class names and
        an image processor (longest side rescale, bottom-right padding, /255)."""
        params: Dict = {"class_names": self.classes}
        input_dim = None
        for t in self.transforms.transforms:
            dim = getattr(t, "input_dim", None)
            if dim is not None:
                input_dim = tuple(dim)
        if input_dim is not None:
            params["image_processor"] = ComposeProcessing(
                [
                    DetectionLongestMaxSizeRescale(input_dim),
                    DetectionBottomRightPadding(input_dim, 114),
                    StandardizeImage(255.0),
                ]
            )
        return params

    def plot(self, max_samples_per_plot: int = 16, plot_transformed_data: bool = True):
        """A grid of the first samples (transformed, or as read) with their boxes drawn in
        red, as an RGB uint8 array; shown too when matplotlib has an interactive backend.
        A transformed sample is drawn from its standardized image, as the JAX dataset
        yields it: ``uint8(clip(x / max_value, 0, 1) * 255)``. PIL is imported here."""
        from PIL import Image, ImageDraw

        n = min(len(self), max_samples_per_plot)
        drawn = []
        for i in range(n):
            if plot_transformed_data:
                image, target = self[i]
                arr = image.transpose(1, 2, 0)
                if self.max_value is not None:
                    arr = np.multiply(arr, np.float32(1.0 / self.max_value), dtype=np.float32)
                boxes = target[target[:, 0] >= 0][:, 1:5]
            else:
                s = self._get_sample(i)
                arr, boxes = s.image, s.bboxes_xyxy
            arr = np.asarray(arr)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            im = Image.fromarray(np.ascontiguousarray(arr))
            d = ImageDraw.Draw(im)
            for b in np.asarray(boxes):
                d.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])], outline=(255, 0, 0), width=2)
            drawn.append(np.asarray(im))
        if not drawn:
            return None
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        h, w, c = drawn[0].shape
        grid = np.zeros((rows * h, cols * w, c), np.uint8)
        for i, im in enumerate(drawn):
            r, cc = divmod(i, cols)
            grid[r * h : (r + 1) * h, cc * w : (cc + 1) * w] = im
        try:
            import matplotlib
        except ImportError:
            return grid
        if matplotlib.get_backend().lower() not in ("agg", "template"):
            import matplotlib.pyplot as plt

            plt.figure(figsize=(10, 10))
            plt.imshow(grid)
            plt.axis("off")
            plt.show()
        return grid

    def get_dataset_classes_information(self) -> np.ndarray:
        """[N, num_classes] per-sample class counts."""
        n_cls = len(self.classes)
        info = np.zeros((len(self._annotations), n_cls), np.int64)
        for i, ann in enumerate(self._annotations):
            labels = np.asarray(ann["labels"], np.int64)
            if len(labels):
                info[i] = np.bincount(labels, minlength=n_cls)[:n_cls]
        return info


class COCOFormatDetectionDataset(DetectionDataset):
    """A COCO instances json (stdlib ``json``; boxes ``[x, y, w, h]``, zero-area ones dropped)."""

    def __init__(self, data_dir: str, json_annotation_file: str, images_dir: str = "", **kwargs):
        self.data_dir = data_dir
        self.json_annotation_file = json_annotation_file
        self.images_dir = images_dir
        super().__init__(**kwargs)

    def _setup(self):
        json_path = os.path.join(self.data_dir, self.json_annotation_file)
        with open(json_path) as f:
            coco = json.load(f)
        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        cat_id_to_contig = {c["id"]: i for i, c in enumerate(cats)}
        self.all_classes_list = [c["name"] for c in cats]

        anns_by_img: Dict[int, List] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0) and not self.with_crowd:
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)

        for img in coco.get("images", []):
            anns = anns_by_img.get(img["id"], [])
            boxes, labels, crowd = [], [], []
            for a in anns:
                x, y, w, h = a["bbox"]
                if w <= 0 or h <= 0:
                    continue
                boxes.append([x, y, x + w, y + h])
                labels.append(cat_id_to_contig[a["category_id"]])
                crowd.append(bool(a.get("iscrowd", 0)))
            self._annotations.append(
                dict(
                    img_path=os.path.join(self.data_dir, self.images_dir, img["file_name"]),
                    boxes_xyxy=np.asarray(boxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int32),
                    is_crowd=np.asarray(crowd, bool),
                )
            )


class COCODetectionDataset(COCOFormatDetectionDataset):
    """The COCO2017 layout: ``<data_dir>/annotations/<json_file>``, images in ``<data_dir>/<subdir>``."""

    def __init__(self, data_dir: str, subdir: str = "images/val2017", json_file: str = "instances_val2017.json", **kwargs):
        super().__init__(
            data_dir=data_dir,
            json_annotation_file=os.path.join("annotations", json_file),
            images_dir=subdir,
            **kwargs,
        )


class YoloDarknetFormatDetectionDataset(DetectionDataset):
    """YOLO txt labels: one ``.txt`` per image with normalized ``cls cx cy w h`` rows."""

    def __init__(self, data_dir: str, images_dir: str, labels_dir: str, classes: Sequence[str], **kwargs):
        self.data_dir = data_dir
        self.images_dir = images_dir
        self.labels_dir = labels_dir
        self._classes_arg = list(classes)
        super().__init__(all_classes_list=list(classes), **kwargs)

    def _setup(self):
        self.all_classes_list = self._classes_arg
        img_dir = os.path.join(self.data_dir, self.images_dir)
        lbl_dir = os.path.join(self.data_dir, self.labels_dir)
        for fname in sorted(os.listdir(img_dir)):
            if not fname.lower().endswith(_IMAGE_EXTENSIONS):
                continue
            img_path = os.path.join(img_dir, fname)
            w, h = image_size(img_path)
            lbl_path = os.path.join(lbl_dir, os.path.splitext(fname)[0] + ".txt")
            boxes, labels = [], []
            if os.path.exists(lbl_path):
                with open(lbl_path) as f:
                    lines = f.read().strip().splitlines()
                for line in lines:
                    parts = line.split()
                    if len(parts) < 5:
                        continue
                    c, cx, cy, bw, bh = float(parts[0]), *map(float, parts[1:5])
                    boxes.append([(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w, (cy + bh / 2) * h])
                    labels.append(int(c))
            self._annotations.append(
                dict(img_path=img_path, boxes_xyxy=np.asarray(boxes, np.float32).reshape(-1, 4), labels=np.asarray(labels, np.int32))
            )
