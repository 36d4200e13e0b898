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
``roboflow_val`` and ``detection_test_dataloader``. Their detection datasets end in
``DetectionStandardize``, so they yield uint8 images and ``max_value`` for the
trainer to standardize on the device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from super_gradients_tpu_torch.common.registry import DATALOADERS, register_dataloader
from super_gradients_tpu_torch.training.datasets import COCODetectionDataset
from super_gradients_tpu_torch.training.datasets_roboflow import RoboflowDetectionDataset
from super_gradients_tpu_torch.training.transforms.detection import (
    DetectionHorizontalFlip,
    DetectionHSV,
    DetectionMixup,
    DetectionMosaic,
    DetectionPaddedRescale,
    DetectionRandomAffine,
    DetectionStandardize,
)


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


class DataLoader(torch.utils.data.DataLoader):
    """A torch DataLoader over an :class:`EpochSampler` (or over ``sampler``, which then
    sets the order alone: ``shuffle`` and ``min_samples`` are not used), with
    ``set_epoch`` and the dataset's ``max_value`` (None when its images are already
    standardized)."""

    def __init__(self, dataset, batch_size: int = 32, shuffle: bool = False, drop_last: bool = True,
                 collate_fn: Optional[Callable] = None, seed: int = 0, min_samples: Optional[int] = None,
                 sampler=None, num_workers: int = 0, prefetch_factor: int = 2):
        num_workers = int(num_workers)
        super().__init__(
            dataset,
            batch_size=int(batch_size),
            sampler=sampler if sampler is not None else EpochSampler(len(dataset), shuffle, seed, min_samples),
            drop_last=drop_last,
            collate_fn=collate_fn,
            num_workers=num_workers,
            pin_memory=torch.cuda.is_available(),
            persistent_workers=num_workers > 0,
            prefetch_factor=int(prefetch_factor) if num_workers > 0 else None,
            worker_init_fn=_seed_worker,
            generator=torch.Generator().manual_seed(seed),
        )

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

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
