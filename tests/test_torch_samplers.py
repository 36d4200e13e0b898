"""The port's samplers and its loader's ``sampler=`` against the JAX package's, on the CPU.

For the same dataset size, seed, rank, replica count and epoch, each port sampler must
yield exactly the JAX sampler's index sequence (``tests/test_samplers.py`` holds the
JAX samplers' behaviour; the same checks run here on the port's).
"""

import numpy as np
import pytest
import torch

from super_gradients_tpu.training import samplers as js
from super_gradients_tpu_torch.training import dataloaders
from super_gradients_tpu_torch.training import samplers as ps


class _FakeDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


class _Info:
    """Per-sample class counts: four classes in 10, 6, 3 and 1 of 12 samples (some twice),
    and the last sample with none."""

    def __init__(self, n=12, seed=0):
        rng = np.random.RandomState(seed)
        self.info = np.zeros((n, 4), np.int64)
        for c, k in enumerate((10, 6, 3, 1)):
            self.info[rng.permutation(n - 1)[:k], c] = rng.randint(1, 3, k)

    def __len__(self):
        return len(self.info)

    def get_dataset_classes_information(self):
        return self.info


def _both(name, *args, **kwargs):
    """The JAX sampler registered under ``name`` and the port's class of that name."""
    return js.SAMPLERS[name](*args, **kwargs), getattr(ps, name)(*args, **kwargs)


def _epochs_equal(ref, got, epochs=(0, 1, 5)):
    assert isinstance(got, torch.utils.data.Sampler)
    for epoch in epochs:
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        assert list(got) == list(ref) and len(got) == len(ref), epoch


@pytest.mark.parametrize("n,replicas,shuffle,drop_last", [(10, 1, True, False), (10, 4, True, False), (10, 4, False, False),
                                                          (10, 3, True, True), (257, 8, True, False)])
def test_distributed_sampler_sequence_equals_jax(n, replicas, shuffle, drop_last):
    for name in ("DistributedSampler", "InfiniteSampler"):
        for rank in range(replicas):
            ref, got = _both(name, _FakeDataset(n), num_replicas=replicas, rank=rank, shuffle=shuffle, seed=7,
                             drop_last=drop_last)
            _epochs_equal(ref, got)


def test_distributed_sampler_partitions_all_indices():
    parts = [list(ps.DistributedSampler(_FakeDataset(10), num_replicas=4, rank=r, shuffle=False)) for r in range(4)]
    assert all(len(p) == 3 for p in parts)
    assert sorted(set(i for p in parts for i in p)) == list(range(10))
    one = ps.DistributedSampler(_FakeDataset(10))  # one process by default
    assert (one.num_replicas, one.rank) == (1, 0) and sorted(one) == list(range(10))


@pytest.mark.parametrize("n,replicas,repeats,selected_round", [(512, 2, 2, 256), (512, 1, 1.5, 0), (300, 4, 3, 0),
                                                               (1000, 3, 3, 256)])
def test_repeat_aug_sampler_sequence_equals_jax(n, replicas, repeats, selected_round):
    for shuffle in (True, False):
        for rank in range(replicas):
            ref, got = _both("RepeatAugSampler", _FakeDataset(n), num_replicas=replicas, rank=rank, shuffle=shuffle,
                             num_repeats=repeats, selected_round=selected_round, seed=3)
            _epochs_equal(ref, got)


@pytest.mark.parametrize("threshold,aggressiveness", [(None, 0.5), (0.2, 1.0)])
def test_class_balancer_and_sampler_equal_jax(tmp_path, threshold, aggressiveness):
    info = _Info()
    factors = ps.ClassBalancer.get_sample_repeat_factors(info, threshold, aggressiveness)
    assert factors == js.ClassBalancer.get_sample_repeat_factors(info, threshold, aggressiveness)
    assert max(factors) > 1.0 and factors[11] == 1.0  # a rare class is oversampled; no class: 1
    ref, got = _both("ClassBalancedSampler", dataset=info, oversample_threshold=threshold,
                     oversample_aggressiveness=aggressiveness, num_samples=50, seed=2)
    _epochs_equal(ref, got)
    path = str(tmp_path / "factors.json")
    ps.ClassBalancer.precompute_sample_repeat_factors(path, info)
    jpath = str(tmp_path / "jax_factors.json")
    js.ClassBalancer.precompute_sample_repeat_factors(jpath, info)
    assert open(path).read() == open(jpath).read()
    assert ps.ClassBalancer.from_precomputed_sample_repeat_factors(path) == \
        js.ClassBalancer.from_precomputed_sample_repeat_factors(jpath)
    ref, got = _both("ClassBalancedSampler", precomputed_factors_file=path, seed=4)
    _epochs_equal(ref, got)
    with pytest.raises(ValueError):
        ps.ClassBalancedSampler()
    with pytest.raises(ValueError):
        ps.ClassBalancedSampler(dataset=_FakeDataset(3))
    with pytest.raises(FileNotFoundError):
        ps.ClassBalancer.from_precomputed_sample_repeat_factors(str(tmp_path / "missing.json"))


def test_class_balanced_sampler_draws_rare_more():
    class Skewed:
        def __len__(self):
            return 10

        def get_dataset_classes_information(self):
            info = np.zeros((10, 2), np.int64)
            info[:9, 0] = 1
            info[9, 1] = 1
            return info

    draws = np.bincount(list(ps.ClassBalancedSampler(dataset=Skewed(), num_samples=2000, seed=0)), minlength=10)
    assert draws[9] > draws[0]


@pytest.mark.parametrize("replicas,shuffle", [(2, False), (3, True)])
def test_distributed_sampler_wrapper_equals_jax(replicas, shuffle):
    for rank in range(replicas):
        inner_j = js.ClassBalancedSampler(dataset=_Info(), num_samples=13, seed=1)
        inner_p = ps.ClassBalancedSampler(dataset=_Info(), num_samples=13, seed=1)
        ref = js.DistributedSamplerWrapper(inner_j, num_replicas=replicas, rank=rank, shuffle=shuffle, seed=5)
        got = ps.DistributedSamplerWrapper(inner_p, num_replicas=replicas, rank=rank, shuffle=shuffle, seed=5)
        _epochs_equal(ref, got)
        assert inner_p.epoch == 5  # set_epoch reached the wrapped sampler


def test_coco_dataset_classes_information_feeds_the_sampler(tmp_path):
    """The port's detection dataset gives the JAX dataset's class counts, so a
    ClassBalancedSampler over either draws the same indices."""
    from test_torch_detection_datasets import write_coco

    from super_gradients_tpu.training.datasets import COCOFormatDetectionDataset as JaxCOCO
    from super_gradients_tpu_torch.training.datasets import COCOFormatDetectionDataset as PortCOCO

    write_coco(str(tmp_path / "images"), str(tmp_path / "coco.json"), 8, np.random.RandomState(0), empty=(2,))
    kw = dict(data_dir=str(tmp_path), json_annotation_file="coco.json", images_dir="images")
    jd, pd = JaxCOCO(**kw), PortCOCO(**kw)
    np.testing.assert_array_equal(pd.get_dataset_classes_information(), jd.get_dataset_classes_information())
    _epochs_equal(js.ClassBalancedSampler(dataset=jd, seed=3), ps.ClassBalancedSampler(dataset=pd, seed=3))


def test_loader_takes_a_sampler_and_passes_set_epoch():
    """``sampler=`` sets the order (as the JAX DataLoader's does), and the loader's
    ``set_epoch`` reaches it; the batches are the JAX loader's."""
    from super_gradients_tpu.training import dataloaders as jax_loaders

    ds = dataloaders.RandomDetectionDataset(num_samples=16, image_size=(8, 8), num_classes=4, max_boxes=4)
    sj = js.DistributedSampler(ds, num_replicas=2, rank=1, shuffle=True, seed=3)
    sp = ps.DistributedSampler(ds, num_replicas=2, rank=1, shuffle=True, seed=3)
    jl = jax_loaders.DataLoader(jax_loaders.RandomDetectionDataset(16, (8, 8), 4, 4), batch_size=4, sampler=sj)
    pl = dataloaders.DataLoader(ds, batch_size=4, sampler=sp, shuffle=False, min_samples=64)
    for epoch in (0, 2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        assert sp.epoch == epoch
        got, ref = list(pl), list(jl)
        assert len(got) == len(ref) == len(pl) == 2
        for (gi, gt), (ri, rt) in zip(got, ref):
            np.testing.assert_array_equal(gi.numpy().transpose(0, 2, 3, 1), ri)
            np.testing.assert_array_equal(gt.numpy(), rt)
