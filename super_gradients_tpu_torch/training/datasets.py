"""Detection, pose, classification and segmentation datasets (counterpart of
``super_gradients_tpu/training/datasets.py``).

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

:class:`COCOPoseEstimationDataset` yields ``(image [3, H, W] float32, targets
[max_poses, 5 + 3J])``.

The classification datasets (:class:`ImageFolderDataset`, :class:`CIFAR10Dataset`,
:class:`CIFAR100Dataset`, :class:`MNISTDataset`) yield ``(image [C, H, W] float32, int32
label)``: the JAX sample, its image CHW. They ship float32, not uint8: CIFAR's images are
normalized by its mean and std, and the others divide by 255.0, which the trainer's uint8
standardize (``x * float32(1/255)``) would miss in the last bit of some pixels.

The segmentation datasets (:class:`SegmentationDataset`, :class:`CityscapesDataset`) yield
``(image [3, H, W] float32, mask [H, W] int32)``: the image resized by PIL's bilinear filter
and divided by 255.0 (float32, as the classification ones), the mask resized by PIL's
nearest filter; Cityscapes labelIds become trainIds through a lookup table, void 255.

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


class COCOPoseEstimationDataset:
    """A COCO ``person_keypoints`` json (stdlib ``json``) -> ``(image [3, H, W], targets
    [max_poses, 5 + 3J])`` (0, x1, y1, x2, y2, J x (x, y, visibility); ``-1`` rows pad).

    Crowd annotations and those with fewer than ``min_visible_joints`` labelled joints
    are skipped, and so are images left without a person. The image is what the chain
    leaves, float32 after ``KeypointsStandardize`` (the JAX division, which the trainer's
    uint8 standardization would not reproduce to the bit). The flip draws from the
    dataset's ``random.Random``, seeded with ``seed`` and reseeded by each loader worker.
    """

    def __init__(self, data_dir: str, json_annotation_file: str, images_dir: str = "", max_poses: int = 30,
                 num_joints: int = 17, transforms: Optional[Sequence] = None, min_visible_joints: int = 1,
                 seed: int = 0):
        from super_gradients_tpu_torch.training.transforms.keypoints import ComposeKeypointTransforms

        self.data_dir = data_dir
        self.images_dir = images_dir
        self.max_poses = max_poses
        self.num_joints = num_joints
        self.transforms = ComposeKeypointTransforms(transforms or [])
        self.rng = random.Random()
        self.reseed(seed)
        with open(os.path.join(data_dir, json_annotation_file)) as f:
            coco = json.load(f)
        anns_by_img: Dict[int, List] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0) or a.get("num_keypoints", 0) < min_visible_joints:
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.items = []
        for img in coco.get("images", []):
            anns = anns_by_img.get(img["id"], [])
            if anns:
                self.items.append((os.path.join(data_dir, images_dir, img["file_name"]), anns))

    def reseed(self, seed: int) -> None:
        """Seed the transforms' generator (a DataLoader worker calls it with its own seed)."""
        self.rng.seed(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        from super_gradients_tpu_torch.training.transforms.keypoints import PoseSample

        path, anns = self.items[i]
        boxes, joints = [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            joints.append(np.asarray(a["keypoints"], np.float32).reshape(self.num_joints, 3))
        sample = PoseSample(load_image(path), np.asarray(boxes, np.float32), np.stack(joints))
        sample = self.transforms(sample, self.rng)
        image = np.asarray(sample.image, np.float32)
        return np.ascontiguousarray(image.transpose(2, 0, 1)), sample.to_padded_targets(self.max_poses)


class ImageFolderDataset:
    """An ImageNet-style ``root/<class>/<image>`` folder: classes in sorted order, their
    images (``.jpg .jpeg .png .bmp .webp``) in sorted order. A sample is the image read by
    PIL, resized to ``image_size`` (PIL bilinear), / 255.0, then ``transforms`` on the HWC
    float32 image, as in the JAX dataset."""

    def __init__(self, root: str, image_size: Tuple[int, int] = (224, 224), transforms=None):
        self.root = root
        self.image_size = tuple(image_size)
        self.transforms = transforms
        self.classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.samples: List[Tuple[str, int]] = []
        exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
        for ci, cls in enumerate(self.classes):
            for fname in sorted(os.listdir(os.path.join(root, cls))):
                if fname.lower().endswith(exts):
                    self.samples.append((os.path.join(root, cls, fname), ci))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, label = self.samples[i]
        pil = _pil_image()
        with pil.open(path) as im:
            im = im.convert("RGB").resize((self.image_size[1], self.image_size[0]), pil.BILINEAR)
            img = np.asarray(im, dtype=np.float32) / 255.0
        if self.transforms:
            img = self.transforms(img)
        return np.ascontiguousarray(np.asarray(img, np.float32).transpose(2, 0, 1)), np.int32(label)


_CIFAR10_MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
_CIFAR10_STD = np.asarray([0.2470, 0.2435, 0.2616], np.float32)
_CIFAR100_MEAN = np.asarray([0.5071, 0.4865, 0.4409], np.float32)
_CIFAR100_STD = np.asarray([0.2673, 0.2564, 0.2762], np.float32)


class _CIFARBase:
    """The CIFAR python-pickle batches. ``train=True`` applies the train augmentations,
    a 32x32 crop of the image zero-padded by 4 and a horizontal flip at 0.5, both drawn
    from the dataset's ``np.random.RandomState`` (seeded with ``seed``, reseeded by each
    loader worker); both splits normalize by the dataset's mean and std."""

    mean = _CIFAR10_MEAN
    std = _CIFAR10_STD

    def __init__(self, root: str, train: bool = True, seed: int = 0):
        import pickle

        self.train = train
        images, labels = [], []
        for fname in self._batch_files(train):
            with open(os.path.join(root, fname), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            data = d[b"data"] if b"data" in d else d["data"]
            lab = d.get(b"labels") or d.get(b"fine_labels") or d.get("labels") or d.get("fine_labels")
            images.append(np.asarray(data, np.uint8).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            labels.append(np.asarray(lab, np.int32))
        self.images = np.concatenate(images)
        self.labels = np.concatenate(labels)
        self.rng = np.random.RandomState(seed)

    def _batch_files(self, train: bool) -> List[str]:
        raise NotImplementedError

    def reseed(self, seed: int) -> None:
        """Seed the augmentations' generator (a DataLoader worker calls it with its own seed)."""
        self.rng.seed(seed % 2**32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = self.images[i].astype(np.float32) / 255.0
        if self.train:
            padded = np.pad(img, ((4, 4), (4, 4), (0, 0)), mode="constant")
            y, x = self.rng.randint(0, 9, size=2)
            img = padded[y : y + 32, x : x + 32]
            if self.rng.rand() < 0.5:
                img = img[:, ::-1]
        img = (img - self.mean) / self.std
        return np.ascontiguousarray(img.transpose(2, 0, 1)), self.labels[i]


class CIFAR10Dataset(_CIFARBase):
    """CIFAR-10 from ``root/cifar-10-batches-py`` (or ``root`` itself)."""

    mean, std = _CIFAR10_MEAN, _CIFAR10_STD

    def __init__(self, root: str, train: bool = True, seed: int = 0):
        sub = os.path.join(root, "cifar-10-batches-py")
        super().__init__(sub if os.path.isdir(sub) else root, train, seed)

    def _batch_files(self, train: bool) -> List[str]:
        return [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]


class CIFAR100Dataset(_CIFARBase):
    """CIFAR-100 from ``root/cifar-100-python`` (or ``root`` itself), fine labels."""

    mean, std = _CIFAR100_MEAN, _CIFAR100_STD

    def __init__(self, root: str, train: bool = True, seed: int = 0):
        sub = os.path.join(root, "cifar-100-python")
        super().__init__(sub if os.path.isdir(sub) else root, train, seed)

    def _batch_files(self, train: bool) -> List[str]:
        return ["train"] if train else ["test"]


class MNISTDataset:
    """MNIST idx files (``train-images-idx3-ubyte[.gz]`` and the labels; ``t10k-*`` for
    ``train=False``) -> ``(image [1, 28, 28] float32 in [0, 1], int label)``."""

    def __init__(self, root: str, train: bool = True):
        import gzip

        prefix = "train" if train else "t10k"

        def read_idx(name):
            for suffix in ("", ".gz"):
                path = os.path.join(root, name + suffix)
                if os.path.exists(path):
                    with (gzip.open if suffix else open)(path, "rb") as f:
                        data = f.read()
                    ndim = data[3]
                    dims = [int.from_bytes(data[4 + 4 * i : 8 + 4 * i], "big") for i in range(ndim)]
                    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)
            raise FileNotFoundError(f"MNIST file {name}[.gz] not found under {root}")

        self.images = read_idx(f"{prefix}-images-idx3-ubyte")
        self.labels = read_idx(f"{prefix}-labels-idx1-ubyte")

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i][None].astype(np.float32) / 255.0, int(self.labels[i])


def _read_resized(path: str, image_hw: Tuple[int, int], mask: bool) -> np.ndarray:
    """An image file resized to ``image_hw`` by PIL: an RGB image bilinearly, / 255.0 in
    float32, ``[3, H, W]``; a mask with the nearest filter, int32 ``[H, W]`` (its first
    channel where it has more)."""
    pil = _pil_image()
    size = (image_hw[1], image_hw[0])
    with pil.open(path) as im:
        if mask:
            out = np.asarray(im.resize(size, pil.NEAREST), np.int32)
            return out[..., 0] if out.ndim == 3 else out
        img = np.asarray(im.convert("RGB").resize(size, pil.BILINEAR), np.float32) / 255.0
    return np.ascontiguousarray(img.transpose(2, 0, 1))


class SegmentationDataset:
    """Paired ``root/images/<name>.<ext>`` and ``root/masks/<name>.(png|jpg|bmp)`` folders,
    the images in sorted order, each sample resized to ``image_size``."""

    def __init__(self, root: str, images_dir: str = "images", masks_dir: str = "masks",
                 image_size: Tuple[int, int] = (512, 512)):
        self.root = root
        self.image_size = tuple(image_size)
        self.img_dir = os.path.join(root, images_dir)
        self.mask_dir = os.path.join(root, masks_dir)
        self.items = [f for f in sorted(os.listdir(self.img_dir)) if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))]

    def __len__(self):
        return len(self.items)

    def _mask_path(self, name: str) -> str:
        base = os.path.splitext(name)[0]
        for ext in (".png", ".jpg", ".bmp"):
            path = os.path.join(self.mask_dir, base + ext)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no mask for {name} in {self.mask_dir}")

    def __getitem__(self, i):
        name = self.items[i]
        return (_read_resized(os.path.join(self.img_dir, name), self.image_size, mask=False),
                _read_resized(self._mask_path(name), self.image_size, mask=True))


# Cityscapes labelId -> trainId (the 19 evaluated classes; every other id is void, 255)
CITYSCAPES_ID_TO_TRAIN_ID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9, 23: 10,
    24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}


class CityscapesDataset:
    """The Cityscapes layout: ``leftImg8bit/<split>/<city>/*_leftImg8bit.png`` with its
    ``gtFine/<split>/<city>/*_gtFine_labelIds.png``, cities and files in sorted order; the
    mask's labelIds mapped to trainIds."""

    def __init__(self, root: str, split: str = "train", image_size: Tuple[int, int] = (512, 1024)):
        self.root = root
        self.image_size = tuple(image_size)
        img_root = os.path.join(root, "leftImg8bit", split)
        gt_root = os.path.join(root, "gtFine", split)
        self.pairs: List[Tuple[str, str]] = []
        for city in sorted(os.listdir(img_root)) if os.path.isdir(img_root) else []:
            for f in sorted(os.listdir(os.path.join(img_root, city))):
                if f.endswith("_leftImg8bit.png"):
                    mask = f.replace("_leftImg8bit.png", "_gtFine_labelIds.png")
                    self.pairs.append((os.path.join(img_root, city, f), os.path.join(gt_root, city, mask)))
        self._lut = np.full(256, 255, np.int32)
        for label_id, train_id in CITYSCAPES_ID_TO_TRAIN_ID.items():
            self._lut[label_id] = train_id

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        img_path, mask_path = self.pairs[i]
        mask = _read_resized(mask_path, self.image_size, mask=True)
        return _read_resized(img_path, self.image_size, mask=False), self._lut[np.clip(mask, 0, 255)]
