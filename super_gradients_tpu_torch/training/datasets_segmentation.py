"""The COCO, Pascal VOC, Mapillary and Supervisely segmentation datasets (counterpart of
``super_gradients_tpu/training/datasets_segmentation.py``).

Each yields ``(image [3, H, W] float32 in [0, 1], mask [H, W] int32)`` at a fixed
``image_size``: the JAX sample, its image CHW, as the port's other segmentation datasets
(``training/datasets.py``). Images are resized by PIL's bilinear filter and divided by 255,
masks by PIL's nearest filter. COCO's masks are rendered on the host: polygons filled through
``PIL.ImageDraw``, RLE decoded by a numpy decoder of COCO's string format (column-major), with
no pycocotools. PIL is imported where a file is read, so the module imports without it.

As in the JAX package, ``CoCoSegmentationDataset`` keeps an image whose kept annotations' summed
``area`` exceeds ``min_pixels``, not one with that many rendered pixels (ROADMAP.md section 3).
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# COCO 2017 (category_id, name) of the 21 PASCAL-like classes the COCO segmentation recipe
# trains (a copy of the JAX package's list; index 0 is the background)
COCO_DEFAULT_CLASSES_TUPLES_LIST = [
    (0, "background"), (5, "airplane"), (2, "bicycle"), (16, "bird"), (9, "boat"),
    (44, "bottle"), (6, "bus"), (3, "car"), (17, "cat"), (62, "chair"), (21, "cow"),
    (67, "dining table"), (18, "dog"), (19, "horse"), (4, "motorcycle"), (1, "person"),
    (64, "potted plant"), (20, "sheep"), (63, "couch"), (7, "train"), (72, "tv"),
]


def _runs_to_mask(runs: Sequence[int], h: int, w: int) -> np.ndarray:
    """Alternating background / foreground run lengths over the column-major ``h x w`` grid."""
    mask = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in runs:
        if val:
            mask[pos:pos + run] = 1
        pos += run
        val ^= 1
    return mask.reshape(w, h).T


def decode_compressed_rle(counts: str, h: int, w: int) -> np.ndarray:
    """COCO's compressed RLE string (6-bit chunks from ``'0'``, each run after the second a
    difference from the run two before) as a binary ``[h, w]`` uint8 mask."""
    runs: List[int] = []
    i, n = 0, len(counts)
    while i < n:
        x, k, more = 0, 0, True
        while more:
            c = ord(counts[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
    return _runs_to_mask(runs, h, w)


def segmentation_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """A COCO ``segmentation`` (a list of polygons, or an RLE dict with string or list
    ``counts``) as a binary ``[H, W]`` uint8 mask; a polygon of fewer than three points draws
    nothing."""
    from PIL import Image, ImageDraw

    if isinstance(segmentation, dict):
        counts = segmentation["counts"]
        sh, sw = segmentation["size"]
        if isinstance(counts, str):
            return decode_compressed_rle(counts, sh, sw)
        return _runs_to_mask(counts, sh, sw)
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in segmentation:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def load_resized(path: str, image_size: Tuple[int, int]) -> np.ndarray:
    """The RGB image at ``image_size`` (PIL bilinear), float32 ``[3, H, W]`` in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB").resize((image_size[1], image_size[0]), Image.BILINEAR), np.float32) / 255.0
    return np.ascontiguousarray(img.transpose(2, 0, 1))


def _read_mask(path: str, image_size: Tuple[int, int], mode: Optional[str] = None) -> np.ndarray:
    """The label image at ``image_size`` (PIL nearest, after ``convert(mode)`` where given), int32."""
    from PIL import Image

    with Image.open(path) as m:
        m = m.convert(mode) if mode else m
        return np.asarray(m.resize((image_size[1], image_size[0]), Image.NEAREST), np.int32)


def resize_mask(mask: np.ndarray, image_size: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(mask.astype(np.uint8)).resize((image_size[1], image_size[0]), Image.NEAREST),
                      np.int32)


class CoCoSegmentationDataset:
    """COCO instances json -> class-index masks over the classes of
    ``dataset_classes_inclusion_tuples_list`` (``COCO_DEFAULT_CLASSES_TUPLES_LIST``).

    The json is ``<data_dir>/annotations/<json_file>``, else ``<data_dir>/<json_file>``; images
    are under ``<data_dir>/<subdir>``. Annotations of other categories and crowd polygons are
    dropped (a crowd RLE is kept); where instances overlap, the first painted keeps the pixel;
    the background class paints nothing. Images whose kept annotations' ``area`` sums to no
    more than ``min_pixels`` are left out, the others kept in the json's annotation order."""

    def __init__(self, data_dir: str, subdir: str = "images/val2017", json_file: str = "instances_val2017.json",
                 dataset_classes_inclusion_tuples_list: Optional[Sequence[Tuple[int, str]]] = None,
                 image_size: Tuple[int, int] = (512, 512), min_pixels: int = 1000):
        self.data_dir = data_dir
        self.subdir = subdir
        self.image_size = tuple(image_size)
        self.inclusion = list(dataset_classes_inclusion_tuples_list or COCO_DEFAULT_CLASSES_TUPLES_LIST)
        self.cat_to_idx = {cat_id: i for i, (cat_id, _) in enumerate(self.inclusion)}
        self.classes = [name for _, name in self.inclusion]

        ann_path = os.path.join(data_dir, "annotations", json_file)
        if not os.path.exists(ann_path):
            ann_path = os.path.join(data_dir, json_file)
        with open(ann_path) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        anns_by_image: dict = {}
        for a in coco["annotations"]:
            if a.get("iscrowd", 0) and not isinstance(a.get("segmentation"), dict):
                continue
            if a["category_id"] in self.cat_to_idx:
                anns_by_image.setdefault(a["image_id"], []).append(a)
        self.items = [(img_id, anns) for img_id, anns in anns_by_image.items()
                      if sum(a.get("area", 0) for a in anns) > min_pixels]

    def __len__(self):
        return len(self.items)

    def render_mask(self, anns, h: int, w: int) -> np.ndarray:
        mask = np.zeros((h, w), np.uint8)
        for a in anns:
            idx = self.cat_to_idx[a["category_id"]]
            if idx == 0:
                continue
            inst = segmentation_to_mask(a["segmentation"], h, w)
            mask += ((mask == 0) & (inst > 0)).astype(np.uint8) * idx
        return mask

    def __getitem__(self, i):
        img_id, anns = self.items[i]
        meta = self.images[img_id]
        img = load_resized(os.path.join(self.data_dir, self.subdir, meta["file_name"]), self.image_size)
        return img, resize_mask(self.render_mask(anns, meta["height"], meta["width"]), self.image_size)


class PascalVOC2012SegmentationDataset:
    """The VOC2012 layout: ``JPEGImages/<name>.jpg`` and ``SegmentationClass/<name>.png``
    palette masks (255 void), the names of ``ImageSets/Segmentation/<split>.txt``, or every mask
    present, sorted, where that list is missing."""

    IGNORE_LABEL = 255
    VOC_CLASSES = [
        "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
        "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
        "pottedplant", "sheep", "sofa", "train", "tvmonitor",
    ]

    def __init__(self, root: str, split: str = "train", image_size: Tuple[int, int] = (512, 512),
                 images_dir: str = "JPEGImages", masks_dir: str = "SegmentationClass"):
        self.root = root
        self.image_size = tuple(image_size)
        self.images_dir = os.path.join(root, images_dir)
        self.masks_dir = os.path.join(root, masks_dir)
        self.classes = list(self.VOC_CLASSES)
        list_path = os.path.join(root, "ImageSets", "Segmentation", f"{split}.txt")
        if os.path.exists(list_path):
            with open(list_path) as f:
                self.names = [ln.strip() for ln in f if ln.strip()]
        else:
            self.names = [os.path.splitext(n)[0] for n in sorted(os.listdir(self.masks_dir)) if n.endswith(".png")]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        name = self.names[i]
        return (load_resized(os.path.join(self.images_dir, name + ".jpg"), self.image_size),
                _read_mask(os.path.join(self.masks_dir, name + ".png"), self.image_size))


class MapillaryDataset:
    """Mapillary Vistas: the labels of ``config_file`` (v1.2: 65 classes, 65 the ignore label)
    and the label PNGs of ``targets_sub_directory`` (sorted) with their JPEGs in
    ``samples_sub_directory``; a 3-channel label is read from its first channel. ``classes``
    leaves out ``Unlabeled``."""

    IGNORE_LABEL_V1_2 = 65

    def __init__(self, root_dir: str, config_file: str = "config_v1.2.json",
                 samples_sub_directory: str = "training/images", targets_sub_directory: str = "training/v1.2/labels",
                 image_size: Tuple[int, int] = (512, 512)):
        self.root = root_dir
        self.image_size = tuple(image_size)
        self.samples_dir = os.path.join(root_dir, samples_sub_directory)
        self.targets_dir = os.path.join(root_dir, targets_sub_directory)
        with open(os.path.join(root_dir, config_file)) as f:
            config = json.load(f)
        self.labels = config["labels"]
        self.label_names = [lb["readable"].replace(" ", "_") for lb in self.labels]
        self.classes = [n for n in self.label_names if n.lower() != "unlabeled"]
        self.names = [os.path.splitext(n)[0] for n in sorted(os.listdir(self.targets_dir)) if n.endswith(".png")]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        name = self.names[i]
        img = load_resized(os.path.join(self.samples_dir, name + ".jpg"), self.image_size)
        mask = _read_mask(os.path.join(self.targets_dir, name + ".png"), self.image_size)
        return img, np.ascontiguousarray(mask[..., 0]) if mask.ndim == 3 else mask


class SuperviselyPersonsDataset:
    """The ``image,mask`` rows of ``<root_dir>/<list_file>`` (paths relative to ``root_dir``),
    a row whose files are missing skipped; the mask is 1 where its grey level is above 0."""

    CLASS_LABELS = {0: "background", 1: "person"}

    def __init__(self, root_dir: str, list_file: str, image_size: Tuple[int, int] = (480, 320)):
        self.root = root_dir
        self.image_size = tuple(image_size)
        self.classes = ["person"]
        self.pairs: List[Tuple[str, str]] = []
        with open(os.path.join(root_dir, list_file), encoding="utf-8") as f:
            for row in csv.reader(f):
                if len(row) < 2:
                    continue
                s, t = os.path.join(root_dir, row[0]), os.path.join(root_dir, row[1])
                if os.path.exists(s) and os.path.exists(t):
                    self.pairs.append((s, t))

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        s, t = self.pairs[i]
        return load_resized(s, self.image_size), (_read_mask(t, self.image_size, "L") > 0).astype(np.int32)
