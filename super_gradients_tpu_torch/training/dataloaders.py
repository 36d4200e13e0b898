"""Data loaders (counterpart of ``super_gradients_tpu/training/dataloaders.py``).

:class:`DataLoader` is a ``torch.utils.data.DataLoader`` that draws its indices in
the JAX loader's order (``RandomState(seed + epoch).shuffle``, a small dataset tiled
up to ``min_samples``), or from a ``sampler=`` of ``training/samplers.py``, pins its
batches when CUDA is present and keeps its worker processes across epochs. Workers
reseed the dataset's generators from their worker seed, which comes from ``seed``:
two loaders with the same seed and worker count yield the same batches. A loader
whose workers cannot start raises; it does not fall back to loading in the main
process.

``get(name, dataset_params, dataloader_params)`` builds a registered loader:
``coco2017_train_yolo_nas`` / ``coco2017_val_yolo_nas``, ``roboflow_train`` /
``roboflow_val``, ``detection_test_dataloader``, ``coco2017_pose_train`` /
``coco2017_pose_val``, ``pose_test_dataloader``, and for classification
``classification_test_dataloader``, ``imagenet_train`` / ``imagenet_val``,
``imagenet_resnet50_train`` / ``imagenet_resnet50_val``,
``cifar10_train`` / ``cifar10_val``, ``cifar100_train`` / ``cifar100_val`` and
``mnist_train`` / ``mnist_val``, and for segmentation ``segmentation_test_dataloader``,
``segmentation_train`` / ``segmentation_val`` (paired image and mask folders, also
registered as ``cityscapes_stdc_seg50_train`` / ``_val``, as in the JAX package),
``cityscapes_train`` / ``cityscapes_val`` and ``cityscapes_{seg50, seg75, ddrnet,
regseg48, segformer}_{train, val}`` (the Cityscapes layout), ``coco_segmentation_{train, val}``,
``pascal_voc_segmentation_{train, val}``, ``mapillary_{train, val}`` and
``supervisely_persons_{train, val}`` (``training/datasets_segmentation.py``). The COCO detection datasets
end in ``DetectionStandardize``, so they yield uint8 images and ``max_value`` for the
trainer to standardize on the device; the pose, classification and segmentation
datasets yield float32 images.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from super_gradients_tpu_torch.common.registry import DATALOADERS, register_dataloader
from super_gradients_tpu_torch.training.datasets import (
    CIFAR10Dataset,
    CIFAR100Dataset,
    CityscapesDataset,
    COCODetectionDataset,
    COCOPoseEstimationDataset,
    ImageFolderDataset,
    MNISTDataset,
    SegmentationDataset,
)
from super_gradients_tpu_torch.training.datasets_roboflow import RoboflowDetectionDataset
from super_gradients_tpu_torch.training.datasets_segmentation import (
    CoCoSegmentationDataset,
    MapillaryDataset,
    PascalVOC2012SegmentationDataset,
    SuperviselyPersonsDataset,
)
from super_gradients_tpu_torch.training.transforms.detection import (
    DetectionHorizontalFlip,
    DetectionHSV,
    DetectionMixup,
    DetectionMosaic,
    DetectionPaddedRescale,
    DetectionRandomAffine,
    DetectionStandardize,
)
from super_gradients_tpu_torch.training.transforms.keypoints import (
    KeypointsHorizontalFlip,
    KeypointsLongestMaxSize,
    KeypointsPadIfNeeded,
    KeypointsStandardize,
)


class RandomClassificationDataset:
    """Images ``[C, H, W]`` float32 in [0, 1) and int32 labels, all drawn up front from
    ``np.random.RandomState(seed)``: the JAX dataset's samples, their images CHW."""

    def __init__(self, num_samples: int = 64, image_size: Tuple[int, int] = (64, 64), num_classes: int = 10,
                 channels: int = 3, seed: int = 0):
        self.num_samples = num_samples
        self.image_size = tuple(image_size)
        self.num_classes = num_classes
        rng = np.random.RandomState(seed)
        images = rng.rand(num_samples, *self.image_size, channels).astype(np.float32)
        self._images = np.ascontiguousarray(images.transpose(0, 3, 1, 2))
        self._labels = rng.randint(0, num_classes, size=num_samples).astype(np.int32)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i):
        return self._images[i], self._labels[i]


class RandomDetectionDataset:
    """Images ``[3, H, W]`` float32 in [0, 1) and padded ``[max_boxes, 5]`` targets
    (cls, x1, y1, x2, y2; ``-1`` rows pad). Sample ``i`` is drawn from
    ``np.random.RandomState(i)``: the JAX dataset's sample ``i``, its image NCHW."""

    def __init__(self, num_samples: int = 32, image_size: Tuple[int, int] = (320, 320), num_classes: int = 80,
                 max_boxes: int = 20):
        self.num_samples = num_samples
        self.image_size = tuple(image_size)
        self.num_classes = num_classes
        self.max_boxes = max_boxes

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        h, w = self.image_size
        img = rng.rand(h, w, 3).astype(np.float32)
        n = rng.randint(1, max(2, self.max_boxes // 2))
        cxy = rng.rand(n, 2) * [w * 0.8, h * 0.8] + [w * 0.1, h * 0.1]
        wh = rng.rand(n, 2) * [w * 0.3, h * 0.3] + 8
        x1y1 = np.maximum(cxy - wh / 2, 0)
        x2y2 = np.minimum(cxy + wh / 2, [w, h])
        cls = rng.randint(0, self.num_classes, size=(n, 1)).astype(np.float32)
        target = np.full((self.max_boxes, 5), -1.0, dtype=np.float32)
        target[:n] = np.concatenate([cls, x1y1, x2y2], axis=1)
        return np.ascontiguousarray(img.transpose(2, 0, 1)), target


class RandomPoseDataset:
    """Images ``[3, H, W]`` float32 in [0, 1) and padded ``[max_poses, 5 + 3J]`` targets
    (0, box, J x (x, y, visibility); ``-1`` rows pad). Sample ``i`` is drawn from
    ``np.random.RandomState(seed + i)``: the JAX dataset's sample ``i``, its image NCHW."""

    def __init__(self, num_samples: int = 16, image_size: Tuple[int, int] = (64, 64), num_joints: int = 17,
                 max_poses: int = 8, seed: int = 0):
        self.num_samples = num_samples
        self.image_size = tuple(image_size)
        self.num_joints = num_joints
        self.max_poses = max_poses
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        h, w = self.image_size
        k = self.num_joints
        img = rng.rand(h, w, 3).astype(np.float32)
        n = rng.randint(1, max(2, self.max_poses // 2))
        target = np.full((self.max_poses, 5 + 3 * k), -1.0, dtype=np.float32)
        for j in range(n):
            cx, cy = rng.rand(2) * [w * 0.6, h * 0.6] + [w * 0.2, h * 0.2]
            bw, bh = rng.rand(2) * [w * 0.3, h * 0.3] + 10
            x1, y1 = max(cx - bw / 2, 0), max(cy - bh / 2, 0)
            x2, y2 = min(cx + bw / 2, w), min(cy + bh / 2, h)
            kp = np.stack([
                rng.uniform(x1, x2, k), rng.uniform(y1, y2, k), rng.randint(0, 3, k).astype(np.float64)
            ], axis=1)
            target[j, 0] = 0.0
            target[j, 1:5] = [x1, y1, x2, y2]
            target[j, 5:] = kp.reshape(-1)
        return np.ascontiguousarray(img.transpose(2, 0, 1)), target


class RandomSegmentationDataset:
    """Images ``[3, H, W]`` float32 in [0, 1) and int32 masks ``[H, W]``; sample ``i`` is
    drawn from ``np.random.RandomState(seed + i)``: the JAX dataset's sample ``i``, its
    image CHW."""

    def __init__(self, num_samples: int = 16, image_size: Tuple[int, int] = (128, 128), num_classes: int = 19,
                 seed: int = 0):
        self.num_samples = num_samples
        self.image_size = tuple(image_size)
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        h, w = self.image_size
        img = rng.rand(h, w, 3).astype(np.float32)
        mask = rng.randint(0, self.num_classes, size=(h, w)).astype(np.int32)
        return np.ascontiguousarray(img.transpose(2, 0, 1)), mask


class EpochSampler(torch.utils.data.Sampler):
    """The JAX ``DataLoader._epoch_indices`` order, epoch by epoch (``set_epoch``)."""

    def __init__(self, num_samples: int, shuffle: bool, seed: int = 0, min_samples: Optional[int] = None):
        if min_samples is not None and num_samples < min_samples:
            self._indices = np.tile(np.arange(num_samples), math.ceil(min_samples / num_samples))[:min_samples]
        else:
            self._indices = np.arange(num_samples)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        idx = self._indices.copy()
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return iter(idx.tolist())

    def __len__(self):
        return len(self._indices)


def _seed_worker(worker_id: int) -> None:
    """Reseed the worker's copy of the dataset from the worker's seed. cv2 keeps its own
    thread pool in a worker, as in the JAX loader's workers (``chip_smoke.py`` phase 11
    times it against cv2 run sequentially: ``PERF.md`` section 5)."""
    info = torch.utils.data.get_worker_info()
    reseed = getattr(info.dataset, "reseed", None)
    if reseed is not None:
        reseed(info.seed)


def loader_max_value(loader) -> Optional[float]:
    """What a loader's uint8 images are divided by: its ``max_value``, or failing that
    its dataset's (a plain ``torch.utils.data.DataLoader`` has none of its own)."""
    value = getattr(loader, "max_value", None)
    return value if value is not None else getattr(getattr(loader, "dataset", None), "max_value", None)


def sample_seed(seed: int, epoch: int, position: int) -> int:
    """The seed of the sample at ``position`` in an epoch's order, under a process group."""
    return int(np.random.SeedSequence([seed, epoch, position]).generate_state(1)[0])


class SeededSamples(torch.utils.data.Dataset):
    """``dataset`` read by ``(index, seed)`` keys: reseeded before each sample, so that its
    random transforms depend on the sample's place in the epoch, not on the rank or the
    worker that loads it. Every other attribute, read or set, is the dataset's."""

    def __init__(self, dataset):
        object.__setattr__(self, "inner", dataset)

    def __getitem__(self, key):
        index, seed = key
        self.inner.reseed(seed)
        return self.inner[index]

    def __len__(self):
        return len(self.inner)

    def __getattr__(self, name):
        if name == "inner":  # not set yet (an unpickled copy)
            raise AttributeError(name)
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        setattr(self.inner, name, value)


class RankBatches(torch.utils.data.Sampler):
    """The global batches of ``order`` (``batch_size`` items, the last one shorter unless
    ``drop_last``), each cut to this rank's :func:`~super_gradients_tpu_torch.parallel.mesh.local_batch_slice`.
    With ``seeded``, each index comes with its sample's seed (:class:`SeededSamples`)."""

    def __init__(self, order, batch_size: int, drop_last: bool, seed: int, seeded: bool):
        from super_gradients_tpu_torch.common.environment import get_world_size

        world = get_world_size()
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} is the global batch: it must divide into the {world} ranks")
        last = len(order) % batch_size
        if not drop_last and 0 < last < world:
            raise ValueError(f"the last batch holds {last} items, fewer than the {world} ranks: set drop_last=True "
                             f"or a batch size that leaves at least one item a rank")
        self.order, self.batch_size, self.drop_last, self.seed, self.seeded = order, batch_size, drop_last, seed, seeded

    def __iter__(self):
        from super_gradients_tpu_torch.parallel.mesh import local_batch_slice

        epoch = getattr(self.order, "epoch", 0)
        indices = list(self.order)
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            batch = indices[start:start + self.batch_size]
            positions = range(start, start + len(batch))[local_batch_slice(len(batch))]
            yield [(indices[p], sample_seed(self.seed, epoch, p)) if self.seeded else indices[p] for p in positions]

    def __len__(self):
        n = len(self.order)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


class DataLoader(torch.utils.data.DataLoader):
    """A torch DataLoader over an :class:`EpochSampler` (or over ``sampler``, which then
    sets the order alone: ``shuffle`` and ``min_samples`` are not used), with
    ``set_epoch`` and the dataset's ``max_value`` (None when its images are already
    standardized).

    ``batch_size`` is the global batch. Under a process group each rank loads its slice
    of every global batch (:class:`RankBatches`): the ranks share the epoch's order, so
    the loader has the one-process loader's length, and a dataset with ``reseed`` draws
    each sample's augmentation from the sample's seed (:class:`SeededSamples`), so the
    global batches do not depend on the world size. Without a group the draws come from
    the dataset's (or its worker's) generator in loading order, as the JAX loader's do:
    N ranks equal a one-rank launch, not that stream. A ``sampler`` that splits the order
    over the ranks itself (``num_replicas`` > 1) is batched by ``batch_size / world``."""

    def __init__(self, dataset, batch_size: int = 32, shuffle: bool = False, drop_last: bool = True,
                 collate_fn: Optional[Callable] = None, seed: int = 0, min_samples: Optional[int] = None,
                 sampler=None, num_workers: int = 0, prefetch_factor: int = 2):
        from super_gradients_tpu_torch.common.environment import get_world_size, process_group_active

        num_workers = int(num_workers)
        order = sampler if sampler is not None else EpochSampler(len(dataset), shuffle, seed, min_samples)
        batching = dict(batch_size=int(batch_size), sampler=order, drop_last=drop_last)
        if process_group_active():
            world = get_world_size()
            if int(getattr(order, "num_replicas", 1)) > 1:
                if batch_size % world:
                    raise ValueError(f"batch_size {batch_size} is the global batch: it must divide into the {world} "
                                     f"ranks")
                batching["batch_size"] = int(batch_size) // world
            else:
                seeded = hasattr(dataset, "reseed")
                dataset = SeededSamples(dataset) if seeded else dataset
                batching = dict(batch_sampler=RankBatches(order, int(batch_size), drop_last, seed, seeded))
        super().__init__(
            dataset,
            **batching,
            collate_fn=collate_fn,
            num_workers=num_workers,
            pin_memory=torch.cuda.is_available(),
            persistent_workers=num_workers > 0,
            prefetch_factor=int(prefetch_factor) if num_workers > 0 else None,
            worker_init_fn=_seed_worker,
            generator=torch.Generator().manual_seed(seed),
        )
        self.order = order

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.order, "set_epoch"):
            self.order.set_epoch(epoch)

    def restart_workers(self) -> None:
        """Shut the persistent workers down: the next iteration starts new ones from the
        dataset as it is now (a stage switch changed its transforms)."""
        iterator = getattr(self, "_iterator", None)
        if iterator is not None and hasattr(iterator, "_shutdown_workers"):
            iterator._shutdown_workers()
        self._iterator = None

    @property
    def max_value(self) -> Optional[float]:
        return getattr(self.dataset, "max_value", None)


_LOADER_KEYS = ("num_workers", "prefetch_factor")


def get(name: Optional[str] = None, dataset=None, dataset_params: Optional[Dict] = None,
        dataloader_params: Optional[Dict] = None) -> DataLoader:
    """A registered loader by name, built from both parameter groups (``dataloader_params``
    wins a key that both hold; workers and prefetch come from ``dataloader_params`` only),
    or a :class:`DataLoader` over ``dataset``."""
    dataset_params = dict(dataset_params or {})
    dataloader_params = dict(dataloader_params or {})
    if name is not None:
        if name not in DATALOADERS:
            raise KeyError(f"Unknown dataloader `{name}`; registered: {sorted(DATALOADERS)}")
        own = {k: v for k, v in dataset_params.items() if k not in _LOADER_KEYS}
        return DATALOADERS[name](**{**own, **dataloader_params})
    if dataset is None:
        raise ValueError("Either `name` or `dataset` must be provided")
    return DataLoader(dataset, **dataloader_params)


def _loader_kwargs(kw: Dict) -> Dict:
    return {k: kw[k] for k in _LOADER_KEYS if k in kw}


def _yolo_nas_train_transforms(input_dim=(640, 640)):
    return [
        DetectionMosaic(input_dim=input_dim, prob=1.0),
        DetectionRandomAffine(degrees=10, translate=0.1, scales=(0.5, 1.5), shear=2.0, target_size=input_dim),
        DetectionMixup(prob=0.5),
        DetectionHSV(prob=1.0, hgain=5, sgain=30, vgain=30),
        DetectionHorizontalFlip(prob=0.5),
        DetectionPaddedRescale(input_dim=input_dim),
        DetectionStandardize(max_value=255.0),
    ]


def _yolo_nas_val_transforms(input_dim=(640, 640)):
    return [DetectionPaddedRescale(input_dim=input_dim), DetectionStandardize(max_value=255.0)]


@register_dataloader("detection_test_dataloader")
def detection_test_dataloader(batch_size: int = 8, image_size: Tuple[int, int] = (320, 320), dataset_size: int = 32,
                              num_classes: int = 80, max_boxes: int = 20, **kw) -> DataLoader:
    return DataLoader(RandomDetectionDataset(dataset_size, image_size, num_classes, max_boxes), batch_size=batch_size,
                      shuffle=True, **_loader_kwargs(kw))


@register_dataloader("coco2017_train_yolo_nas")
@register_dataloader("coco2017_train")
def coco2017_train_yolo_nas(data_dir: str, batch_size: int = 16, input_dim=(640, 640), max_boxes: int = 120,
                            subdir: str = "images/train2017", json_file: str = "instances_train2017.json", **kw) -> DataLoader:
    ds = COCODetectionDataset(
        data_dir=data_dir, subdir=subdir, json_file=json_file,
        transforms=_yolo_nas_train_transforms(tuple(input_dim)), max_boxes=max_boxes,
        ignore_empty_annotations=True,
    )
    return DataLoader(ds, batch_size=batch_size, shuffle=True, drop_last=True, **_loader_kwargs(kw))


@register_dataloader("coco2017_val_yolo_nas")
@register_dataloader("coco2017_val")
def coco2017_val_yolo_nas(data_dir: str, batch_size: int = 32, input_dim=(640, 640), max_boxes: int = 120,
                          subdir: str = "images/val2017", json_file: str = "instances_val2017.json",
                          with_crowd: bool = True, **kw) -> DataLoader:
    """COCO val loader; ``with_crowd`` gives ``[B, max_boxes, 6]`` targets whose is-crowd
    column ``DetectionMetrics`` matches crowd boxes by (as pycocotools does)."""
    ds = COCODetectionDataset(
        data_dir=data_dir, subdir=subdir, json_file=json_file,
        transforms=_yolo_nas_val_transforms(tuple(input_dim)), max_boxes=max_boxes,
        with_crowd=with_crowd,
    )
    return DataLoader(ds, batch_size=batch_size, shuffle=False, drop_last=False, **_loader_kwargs(kw))


class PPYoloEMultiScaleCollate:
    """Multi-scale batch resize of the PP-YOLOE COCO loader (the JAX package's): the
    sizes cycle through a fixed list keyed by a batch counter that starts at ``seed`` and
    counts up before each batch. A batch of another height is resized as
    ``jax.image.resize(..., "bilinear")`` does (half-pixel, antialiased where it shrinks:
    ``F.interpolate(antialias=True)``) to that height and ``round(w * scale)``, and every
    box coordinate >= 0 is scaled. uint8 images are standardized first, ``x * float32(1 /
    255)`` as the trainer does on the device for the detection chains'
    ``DetectionStandardize(255)``, so a resized batch leaves as float32 in [0, 1] (the trainer
    passes a float batch unchanged) and one at its own size as uint8."""

    def __init__(self, sizes=(480, 512, 544, 576, 608, 640), seed: int = 0):
        self.sizes = tuple(int(s) for s in sizes)
        self._count = seed

    def __call__(self, samples):
        from super_gradients_tpu_torch.models.segmentation.ppliteseg import resize_linear

        images = torch.from_numpy(np.stack([np.asarray(s[0]) for s in samples]))
        targets = torch.from_numpy(np.stack([np.asarray(s[1]) for s in samples]))
        self._count += 1
        size = self.sizes[self._count % len(self.sizes)]
        if images.shape[2] != size:
            scale = size / images.shape[2]
            if images.dtype == torch.uint8:
                images = images.float().mul_(float(np.float32(1.0 / 255.0)))
            images = resize_linear(images, (size, int(round(images.shape[3] * scale))))
            targets = targets.clone()
            box = targets[..., 1:5]
            targets[..., 1:5] = torch.where(box >= 0, box * scale, box)
        return images, targets


@register_dataloader("coco2017_train_ppyoloe")
def coco2017_train_ppyoloe(data_dir: str, batch_size: int = 16, input_dim=(640, 640), max_boxes: int = 120,
                           multiscale: bool = False, subdir: str = "images/train2017",
                           json_file: str = "instances_train2017.json", **kw) -> DataLoader:
    """The YOLO-NAS COCO train loader, batches resized by :class:`PPYoloEMultiScaleCollate` with ``multiscale``."""
    ds = COCODetectionDataset(
        data_dir=data_dir, subdir=subdir, json_file=json_file,
        transforms=_yolo_nas_train_transforms(tuple(input_dim)), max_boxes=max_boxes,
        ignore_empty_annotations=True,
    )
    collate = PPYoloEMultiScaleCollate() if multiscale else None
    return DataLoader(ds, batch_size=batch_size, shuffle=True, drop_last=True, collate_fn=collate, **_loader_kwargs(kw))


@register_dataloader("coco2017_val_ppyoloe")
def coco2017_val_ppyoloe(data_dir: str, batch_size: int = 32, input_dim=(640, 640), max_boxes: int = 120,
                         subdir: str = "images/val2017", json_file: str = "instances_val2017.json", **kw) -> DataLoader:
    return coco2017_val_yolo_nas(data_dir, batch_size, input_dim, max_boxes, subdir, json_file, **_loader_kwargs(kw))


@register_dataloader("coco2017_train_yolox")
def coco2017_train_yolox(data_dir: str, batch_size: int = 16, input_dim=(640, 640), max_boxes: int = 120,
                         **kw) -> DataLoader:
    return coco2017_train_yolo_nas(data_dir, batch_size, input_dim, max_boxes, **kw)


@register_dataloader("coco2017_val_yolox")
def coco2017_val_yolox(data_dir: str, batch_size: int = 32, input_dim=(640, 640), max_boxes: int = 120,
                       **kw) -> DataLoader:
    return coco2017_val_yolo_nas(data_dir, batch_size, input_dim, max_boxes, **kw)


@register_dataloader("coco2017_train_ssd_lite_mobilenet_v2")
def coco2017_train_ssd(data_dir: str, batch_size: int = 32, input_dim=(320, 320), max_boxes: int = 120,
                       **kw) -> DataLoader:
    return coco2017_train_yolo_nas(data_dir, batch_size, input_dim, max_boxes, **kw)


@register_dataloader("coco2017_val_ssd_lite_mobilenet_v2")
def coco2017_val_ssd(data_dir: str, batch_size: int = 32, input_dim=(320, 320), max_boxes: int = 120,
                     **kw) -> DataLoader:
    return coco2017_val_yolo_nas(data_dir, batch_size, input_dim, max_boxes, **kw)


@register_dataloader("roboflow_train")
def roboflow_train(data_dir: str, dataset_name: str, batch_size: int = 16, image_size=(640, 640), **kw) -> DataLoader:
    ds = RoboflowDetectionDataset(data_dir=data_dir, dataset_name=dataset_name, split="train",
                                  transforms=_yolo_nas_train_transforms(tuple(image_size)))
    return DataLoader(ds, batch_size=batch_size, shuffle=True, drop_last=True, **_loader_kwargs(kw))


@register_dataloader("roboflow_val")
def roboflow_val(data_dir: str, dataset_name: str, batch_size: int = 32, image_size=(640, 640), **kw) -> DataLoader:
    ds = RoboflowDetectionDataset(data_dir=data_dir, dataset_name=dataset_name, split="valid",
                                  transforms=_yolo_nas_val_transforms(tuple(image_size)))
    return DataLoader(ds, batch_size=batch_size, shuffle=False, drop_last=False, **_loader_kwargs(kw))


@register_dataloader("pose_test_dataloader")
def pose_test_dataloader(batch_size: int = 8, image_size: Tuple[int, int] = (64, 64), dataset_size: int = 16,
                         num_joints: int = 17, **kw) -> DataLoader:
    return DataLoader(RandomPoseDataset(dataset_size, image_size, num_joints), batch_size=batch_size, shuffle=True,
                      **_loader_kwargs(kw))


def _pose_transforms(image_size, train: bool):
    ts = [KeypointsLongestMaxSize(max_height=image_size[0], max_width=image_size[1]),
          KeypointsPadIfNeeded(min_height=image_size[0], min_width=image_size[1]),
          KeypointsStandardize(max_value=255.0)]
    if train:
        ts.insert(0, KeypointsHorizontalFlip(prob=0.5))
    return ts


@register_dataloader("coco2017_pose_train")
def coco2017_pose_train(data_dir: str, batch_size: int = 16, image_size=(640, 640), max_poses: int = 30,
                        json_file: str = "person_keypoints_train2017.json", subdir: str = "images/train2017",
                        **kw) -> DataLoader:
    ds = COCOPoseEstimationDataset(data_dir=data_dir, json_annotation_file=json_file, images_dir=subdir,
                                   max_poses=max_poses, transforms=_pose_transforms(tuple(image_size), True))
    return DataLoader(ds, batch_size=batch_size, shuffle=True, drop_last=True, **_loader_kwargs(kw))


@register_dataloader("coco2017_pose_val")
def coco2017_pose_val(data_dir: str, batch_size: int = 32, image_size=(640, 640), max_poses: int = 30,
                      json_file: str = "person_keypoints_val2017.json", subdir: str = "images/val2017",
                      **kw) -> DataLoader:
    ds = COCOPoseEstimationDataset(data_dir=data_dir, json_annotation_file=json_file, images_dir=subdir,
                                   max_poses=max_poses, transforms=_pose_transforms(tuple(image_size), False))
    return DataLoader(ds, batch_size=batch_size, shuffle=False, drop_last=False, **_loader_kwargs(kw))


@register_dataloader("classification_test_dataloader")
def classification_test_dataloader(batch_size: int = 16, image_size: Tuple[int, int] = (64, 64), dataset_size: int = 64,
                                   num_classes: int = 10, **kw) -> DataLoader:
    return DataLoader(RandomClassificationDataset(dataset_size, image_size, num_classes), batch_size=batch_size,
                      shuffle=True, **_loader_kwargs(kw))


@register_dataloader("imagenet_train")
def imagenet_train(data_dir: str, batch_size: int = 128, image_size=(224, 224), **kw) -> DataLoader:
    return DataLoader(ImageFolderDataset(data_dir, tuple(image_size)), batch_size=batch_size, shuffle=True,
                      **_loader_kwargs(kw))


@register_dataloader("imagenet_val")
def imagenet_val(data_dir: str, batch_size: int = 128, image_size=(224, 224), **kw) -> DataLoader:
    return DataLoader(ImageFolderDataset(data_dir, tuple(image_size)), batch_size=batch_size, shuffle=False,
                      drop_last=False, **_loader_kwargs(kw))


def _split_dir(data_dir: str, split: str) -> str:
    """``data_dir/<split>`` where that folder exists, else ``data_dir`` itself."""
    sub = os.path.join(data_dir, split)
    return sub if os.path.isdir(sub) else data_dir


# the ImageNet recipes' loaders (JAX `_register_imagenet_family`): one ImageFolder loader at 224
IMAGENET_FAMILIES = ("resnet50", "efficientnet", "mobilenetv2", "mobilenetv3", "regnetY", "repvgg", "vit_base",
                     "vit_large")


def imagenet_resnet50_train(data_dir: str, batch_size: int = 128, **kw) -> DataLoader:
    """The ImageNet recipes' train loader: the ImageFolder of ``data_dir/train`` (or of
    ``data_dir``) at 224x224."""
    return DataLoader(ImageFolderDataset(_split_dir(data_dir, "train"), (224, 224)), batch_size=batch_size,
                      shuffle=True, **_loader_kwargs(kw))


def imagenet_resnet50_val(data_dir: str, batch_size: int = 128, **kw) -> DataLoader:
    return DataLoader(ImageFolderDataset(_split_dir(data_dir, "val"), (224, 224)), batch_size=batch_size,
                      shuffle=False, drop_last=False, **_loader_kwargs(kw))


for _family in IMAGENET_FAMILIES:
    register_dataloader(f"imagenet_{_family}_train")(imagenet_resnet50_train)
    register_dataloader(f"imagenet_{_family}_val")(imagenet_resnet50_val)


@register_dataloader("cifar10_train")
def cifar10_train(root: str = "/data/cifar10", batch_size: int = 256, **kw) -> DataLoader:
    return DataLoader(CIFAR10Dataset(root, train=True), batch_size=batch_size, shuffle=True, drop_last=True,
                      **_loader_kwargs(kw))


@register_dataloader("cifar10_val")
def cifar10_val(root: str = "/data/cifar10", batch_size: int = 512, **kw) -> DataLoader:
    return DataLoader(CIFAR10Dataset(root, train=False), batch_size=batch_size, shuffle=False, drop_last=False,
                      **_loader_kwargs(kw))


@register_dataloader("cifar100_train")
def cifar100_train(root: str = "/data/cifar100", batch_size: int = 256, **kw) -> DataLoader:
    return DataLoader(CIFAR100Dataset(root, train=True), batch_size=batch_size, shuffle=True, drop_last=True,
                      **_loader_kwargs(kw))


@register_dataloader("cifar100_val")
def cifar100_val(root: str = "/data/cifar100", batch_size: int = 512, **kw) -> DataLoader:
    return DataLoader(CIFAR100Dataset(root, train=False), batch_size=batch_size, shuffle=False, drop_last=False,
                      **_loader_kwargs(kw))


@register_dataloader("mnist_train")
def mnist_train(root: str = "/data/mnist", batch_size: int = 256, **kw) -> DataLoader:
    return DataLoader(MNISTDataset(root, train=True), batch_size=batch_size, shuffle=True, drop_last=True,
                      **_loader_kwargs(kw))


@register_dataloader("mnist_val")
def mnist_val(root: str = "/data/mnist", batch_size: int = 512, **kw) -> DataLoader:
    return DataLoader(MNISTDataset(root, train=False), batch_size=batch_size, shuffle=False, drop_last=False,
                      **_loader_kwargs(kw))


@register_dataloader("segmentation_test_dataloader")
def segmentation_test_dataloader(batch_size: int = 4, image_size: Tuple[int, int] = (128, 128), dataset_size: int = 16,
                                 num_classes: int = 19, **kw) -> DataLoader:
    return DataLoader(RandomSegmentationDataset(dataset_size, image_size, num_classes), batch_size=batch_size,
                      shuffle=True, **_loader_kwargs(kw))


# the JAX package registers the STDC-Seg50 recipe's loader names as these paired-folder
# loaders, not as the Cityscapes layout (ROADMAP.md section 3): kept as they are
@register_dataloader("segmentation_train")
@register_dataloader("cityscapes_stdc_seg50_train")
def segmentation_train(root: str, batch_size: int = 8, image_size=(512, 1024), **kw) -> DataLoader:
    return DataLoader(SegmentationDataset(root, image_size=tuple(image_size)), batch_size=batch_size, shuffle=True,
                      **_loader_kwargs(kw))


@register_dataloader("segmentation_val")
@register_dataloader("cityscapes_stdc_seg50_val")
def segmentation_val(root: str, batch_size: int = 8, image_size=(512, 1024), **kw) -> DataLoader:
    return DataLoader(SegmentationDataset(root, image_size=tuple(image_size)), batch_size=batch_size, shuffle=False,
                      drop_last=False, **_loader_kwargs(kw))


def _cityscapes_loader(root: str, split: str, batch_size: int, image_size, shuffle: bool, kw: Dict) -> DataLoader:
    """The Cityscapes ``split`` at ``image_size``; a train loader shuffles and drops its last
    partial batch."""
    return DataLoader(CityscapesDataset(root=root, split=split, image_size=tuple(image_size)), batch_size=batch_size,
                      shuffle=shuffle, drop_last=shuffle, **_loader_kwargs(kw))


def _register_cityscapes_family(name: str, train_size, val_size) -> None:
    @register_dataloader(f"cityscapes_{name}_train")
    def _train(root: str, batch_size: int = 8, image_size=None, **kw) -> DataLoader:
        return _cityscapes_loader(root, "train", batch_size, image_size or train_size, True, kw)

    @register_dataloader(f"cityscapes_{name}_val")
    def _val(root: str, batch_size: int = 8, image_size=None, **kw) -> DataLoader:
        return _cityscapes_loader(root, "val", batch_size, image_size or val_size, False, kw)


for _name, _train_size, _val_size in [("seg50", (512, 1024), (512, 1024)), ("seg75", (768, 1536), (768, 1536)),
                                      ("ddrnet", (1024, 1024), (1024, 2048)), ("regseg48", (1024, 1024), (1024, 2048)),
                                      ("segformer", (1024, 1024), (1024, 2048))]:
    _register_cityscapes_family(_name, _train_size, _val_size)


@register_dataloader("cityscapes_train")
def cityscapes_train(root: str, batch_size: int = 8, image_size=(512, 1024), **kw) -> DataLoader:
    return _cityscapes_loader(root, "train", batch_size, image_size, True, kw)


@register_dataloader("cityscapes_val")
def cityscapes_val(root: str, batch_size: int = 8, image_size=(512, 1024), **kw) -> DataLoader:
    return _cityscapes_loader(root, "val", batch_size, image_size, False, kw)


# the COCO, VOC, Mapillary and Supervisely segmentation loaders: a train loader shuffles and
# drops its last partial batch, a val loader does neither (the JAX package's arguments)
def _seg_loader(dataset, batch_size: int, train: bool, kw: Dict) -> DataLoader:
    return DataLoader(dataset, batch_size=batch_size, shuffle=train, drop_last=train, **_loader_kwargs(kw))


@register_dataloader("coco_segmentation_train")
def coco_segmentation_train(data_dir: str, batch_size: int = 16, image_size=(512, 512), **kw) -> DataLoader:
    ds = CoCoSegmentationDataset(data_dir, subdir="images/train2017", json_file="instances_train2017.json",
                                 image_size=tuple(image_size))
    return _seg_loader(ds, batch_size, True, kw)


@register_dataloader("coco_segmentation_val")
def coco_segmentation_val(data_dir: str, batch_size: int = 16, image_size=(512, 512), **kw) -> DataLoader:
    ds = CoCoSegmentationDataset(data_dir, subdir="images/val2017", json_file="instances_val2017.json",
                                 image_size=tuple(image_size))
    return _seg_loader(ds, batch_size, False, kw)


@register_dataloader("pascal_voc_segmentation_train")
def pascal_voc_segmentation_train(root: str, batch_size: int = 16, image_size=(512, 512), **kw) -> DataLoader:
    return _seg_loader(PascalVOC2012SegmentationDataset(root, "train", tuple(image_size)), batch_size, True, kw)


@register_dataloader("pascal_voc_segmentation_val")
def pascal_voc_segmentation_val(root: str, batch_size: int = 16, image_size=(512, 512), **kw) -> DataLoader:
    return _seg_loader(PascalVOC2012SegmentationDataset(root, "val", tuple(image_size)), batch_size, False, kw)


@register_dataloader("mapillary_train")
def mapillary_train(root_dir: str, batch_size: int = 8, image_size=(512, 512), **kw) -> DataLoader:
    ds = MapillaryDataset(root_dir, samples_sub_directory="training/images",
                          targets_sub_directory="training/v1.2/labels", image_size=tuple(image_size))
    return _seg_loader(ds, batch_size, True, kw)


@register_dataloader("mapillary_val")
def mapillary_val(root_dir: str, batch_size: int = 8, image_size=(512, 512), **kw) -> DataLoader:
    ds = MapillaryDataset(root_dir, samples_sub_directory="validation/images",
                          targets_sub_directory="validation/v1.2/labels", image_size=tuple(image_size))
    return _seg_loader(ds, batch_size, False, kw)


@register_dataloader("supervisely_persons_train")
def supervisely_persons_train(root_dir: str, batch_size: int = 16, image_size=(480, 320), **kw) -> DataLoader:
    return _seg_loader(SuperviselyPersonsDataset(root_dir, "train.csv", tuple(image_size)), batch_size, True, kw)


@register_dataloader("supervisely_persons_val")
def supervisely_persons_val(root_dir: str, batch_size: int = 16, image_size=(480, 320), **kw) -> DataLoader:
    return _seg_loader(SuperviselyPersonsDataset(root_dir, "val.csv", tuple(image_size)), batch_size, False, kw)
