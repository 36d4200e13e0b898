"""Index samplers (counterpart of ``super_gradients_tpu/training/samplers.py``).

Each sampler is a ``torch.utils.data.Sampler`` with ``set_epoch`` and yields, for the
same dataset size, seed, rank, replica count and epoch, the index sequence of the JAX
sampler of the same name: every shuffle is ``np.random.RandomState(seed + epoch)``.
``num_replicas`` / ``rank`` default to one process (a multi-GPU run is ROADMAP.md
queue 1, 'Deployment and scale-out').

Pass one to :class:`~super_gradients_tpu_torch.training.dataloaders.DataLoader` as
``sampler=``; the loader hands its ``set_epoch`` on.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional

import numpy as np
import torch


def _process_info(num_replicas: Optional[int], rank: Optional[int]):
    return int(1 if num_replicas is None else num_replicas), int(0 if rank is None else rank)


class Sampler(torch.utils.data.Sampler):
    """Yields dataset indices, one pass an epoch; ``set_epoch`` reseeds the next pass."""

    epoch: int = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)


class DistributedSampler(Sampler):
    """Epoch-seeded shuffle, padded (or cut with ``drop_last``) to a multiple of the
    replicas, then each replica's strided slice. ``InfiniteSampler`` is the same class."""

    def __init__(self, dataset, num_replicas: Optional[int] = None, rank: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.dataset_len = len(dataset)
        self.num_replicas, self.rank = _process_info(num_replicas, rank)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = self.dataset_len // self.num_replicas
        else:
            self.num_samples = math.ceil(self.dataset_len / self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def __iter__(self):
        if self.shuffle:
            indices = np.random.RandomState(self.seed + self.epoch).permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        if not self.drop_last:
            pad = self.total_size - len(indices)
            if pad > 0:
                indices = np.concatenate([indices, indices[:pad]])
        indices = indices[: self.total_size]
        return iter(indices[self.rank :: self.num_replicas].tolist())

    def __len__(self):
        return self.num_samples


InfiniteSampler = DistributedSampler


class RepeatAugSampler(Sampler):
    """Repeated augmentation: each sample ``num_repeats`` times, the repeats spread over
    the replicas, each replica's share cut to ``num_selected_samples`` an epoch."""

    def __init__(self, dataset, num_replicas: Optional[int] = None, rank: Optional[int] = None,
                 shuffle: bool = True, num_repeats: int = 3, selected_round: int = 256,
                 selected_ratio: int = 0, seed: int = 0):
        self.dataset_len = len(dataset)
        self.num_replicas, self.rank = _process_info(num_replicas, rank)
        self.shuffle = shuffle
        self.num_repeats = num_repeats
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(math.ceil(self.dataset_len * num_repeats / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas
        selected_ratio = selected_ratio or self.num_replicas
        if selected_round:
            self.num_selected_samples = int(math.floor(self.dataset_len // selected_round * selected_round / selected_ratio))
        else:
            self.num_selected_samples = int(math.ceil(self.dataset_len / selected_ratio))

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        indices = rng.permutation(self.dataset_len) if self.shuffle else np.arange(self.dataset_len)
        if isinstance(self.num_repeats, float) and not float(self.num_repeats).is_integer():
            repeat_size = math.ceil(self.num_repeats * self.dataset_len)
            indices = indices[np.asarray([int(i // self.num_repeats) for i in range(repeat_size)])]
        else:
            indices = np.repeat(indices, int(self.num_repeats))
        pad = self.total_size - len(indices)
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        indices = indices[self.rank : self.total_size : self.num_replicas]
        return iter(indices[: self.num_selected_samples].tolist())

    def __len__(self):
        return self.num_selected_samples


def _default_oversample_heuristic(class_frequencies: np.ndarray, oversample_threshold: Optional[float] = None,
                                  oversample_aggressiveness: float = 0.5) -> np.ndarray:
    """LVIS repeat factor of each class (arXiv:1908.03195): ``(t / f) ** aggressiveness``
    for a class whose image frequency ``f`` is at most ``t`` (the median by default)."""
    if oversample_threshold is None:
        oversample_threshold = float(np.median(class_frequencies))
    result = np.ones_like(class_frequencies, dtype=np.float32)
    nz = (class_frequencies > 0) & (class_frequencies <= oversample_threshold)
    result[nz] = (oversample_threshold / class_frequencies[nz]) ** oversample_aggressiveness
    return result


class ClassBalancer:
    """Per-sample repeat factors from a dataset's ``get_dataset_classes_information()``
    (``[N, C]`` class counts): each sample takes the largest factor of its classes."""

    @staticmethod
    def get_sample_repeat_factors(class_information_provider, oversample_threshold: Optional[float] = None,
                                  oversample_aggressiveness: float = 0.5) -> List[float]:
        info = np.asarray(class_information_provider.get_dataset_classes_information())  # [N, C]
        freq = info.sum(0) / len(info)
        category_repeat = _default_oversample_heuristic(freq, oversample_threshold, oversample_aggressiveness)
        present = info != 0
        factors = np.where(present.any(1), np.where(present, category_repeat, 0.0).max(1), 1.0)
        return factors.astype(np.float64).tolist()

    @staticmethod
    def precompute_sample_repeat_factors(output_path: str, class_information_provider,
                                         oversample_threshold: Optional[float] = None):
        factors = ClassBalancer.get_sample_repeat_factors(class_information_provider, oversample_threshold)
        with open(output_path, "w", encoding="utf-8") as f:
            json.dump([np.format_float_positional(v, trim="0", precision=4) for v in factors], f)

    @staticmethod
    def from_precomputed_sample_repeat_factors(precomputed_path: str) -> List[float]:
        if not os.path.exists(precomputed_path):
            raise FileNotFoundError(f"`{precomputed_path}` does not exist.")
        with open(precomputed_path, "r") as f:
            return [float(v) for v in json.load(f)]


class ClassBalancedSampler(Sampler):
    """``num_samples`` indices drawn with replacement, each with the probability of its
    repeat factor (:class:`ClassBalancer`, or a file it precomputed)."""

    def __init__(self, dataset=None, precomputed_factors_file: Optional[str] = None,
                 oversample_threshold: Optional[float] = None, oversample_aggressiveness: float = 0.5,
                 num_samples: Optional[int] = None, seed: int = 0):
        if dataset is None and precomputed_factors_file is None:
            raise ValueError("`dataset` and `precomputed_factors_file` cannot both be None.")
        if precomputed_factors_file is not None:
            factors = ClassBalancer.from_precomputed_sample_repeat_factors(precomputed_factors_file)
        else:
            if not hasattr(dataset, "get_dataset_classes_information"):
                raise ValueError("`dataset` must expose get_dataset_classes_information() ([N, C] counts).")
            factors = ClassBalancer.get_sample_repeat_factors(dataset, oversample_threshold, oversample_aggressiveness)
        w = np.asarray(factors, np.float64)
        self.weights = w / w.sum()
        self.num_samples = num_samples or len(w)
        self.seed = seed
        self.epoch = 0

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        return iter(rng.choice(len(self.weights), size=self.num_samples, replace=True, p=self.weights).tolist())

    def __len__(self):
        return self.num_samples


class DistributedSamplerWrapper(Sampler):
    """Shards any sampler's pass across replicas (optionally reshuffled by epoch);
    ``set_epoch`` reaches the wrapped sampler too."""

    def __init__(self, sampler, num_replicas: Optional[int] = None, rank: Optional[int] = None, shuffle: bool = False,
                 seed: int = 0):
        self.sampler = sampler
        self.num_replicas, self.rank = _process_info(num_replicas, rank)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = math.ceil(len(sampler) / self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __iter__(self):
        indices = np.asarray(list(iter(self.sampler)))
        if self.shuffle:
            indices = indices[np.random.RandomState(self.seed + self.epoch).permutation(len(indices))]
        pad = self.total_size - len(indices)
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        return iter(indices[self.rank :: self.num_replicas].tolist())

    def __len__(self):
        return self.num_samples
