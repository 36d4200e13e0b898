"""Classification data of the PyTorch port against the JAX package's: transforms,
datasets and named loaders.

Inputs are written to ``tmp_path`` from a seed: CIFAR-10 / CIFAR-100 python pickles,
MNIST idx files (raw and gzipped) and an ImageFolder of PNGs in several sizes. Each port
sample is the JAX sample with its image CHW, byte for byte, the CIFAR train
augmentations included (crop and flip drawn from the dataset's ``RandomState``), at 0
loader workers. With workers, each worker reseeds the dataset's generator from the
loader's seed: two loaders of one seed give the same batches. ``RandAugment``,
``RandomErase``, ``mixup_batch`` and ``cutmix_batch`` give JAX's images and soft labels
for the same seeds.
"""

import gzip
import os
import pickle
import random
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu.training import datasets as jax_datasets
from super_gradients_tpu.training.transforms import classification as jax_transforms
from super_gradients_tpu_torch.training import dataloaders, datasets
from super_gradients_tpu_torch.training.transforms import classification as port_transforms

torch.set_num_threads(2)


def write_cifar(root, n_per_batch=16, seed=0, cifar100=False):
    """CIFAR pickles with a class-dependent grey level plus noise."""
    rng = np.random.RandomState(seed)
    sub = os.path.join(root, "cifar-100-python" if cifar100 else "cifar-10-batches-py")
    os.makedirs(sub, exist_ok=True)
    names = ["train", "test"] if cifar100 else [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    n_classes = 100 if cifar100 else 10
    key = b"fine_labels" if cifar100 else b"labels"
    for name in names:
        labels = rng.randint(0, n_classes, n_per_batch)
        data = (labels[:, None] * (250 // n_classes) + rng.randint(0, 60, (n_per_batch, 3072))).clip(0, 255)
        with open(os.path.join(sub, name), "wb") as f:
            pickle.dump({b"data": data.astype(np.uint8), key: labels.tolist()}, f)
    return root


def write_mnist(root, n_train=24, n_val=12, seed=0, gz=False):
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)

    def write(name, arr):
        payload = bytes([0, 0, 8, arr.ndim]) + b"".join(struct.pack(">I", d) for d in arr.shape) + arr.tobytes()
        with (gzip.open if gz else open)(os.path.join(root, name + (".gz" if gz else "")), "wb") as f:
            f.write(payload)

    for prefix, n in (("train", n_train), ("t10k", n_val)):
        write(f"{prefix}-images-idx3-ubyte", rng.randint(0, 256, (n, 28, 28), dtype=np.uint8))
        write(f"{prefix}-labels-idx1-ubyte", rng.randint(0, 10, n).astype(np.uint8))
    return root


def write_image_folder(root, n_classes=3, per_class=3, seed=0):
    rng = np.random.RandomState(seed)
    sizes = [(40, 56), (64, 48), (33, 71)]
    for c in range(n_classes):
        os.makedirs(os.path.join(root, f"class_{c}"), exist_ok=True)
        for i in range(per_class):
            h, w = sizes[(c + i) % len(sizes)]
            Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(root, f"class_{c}", f"{i}.png"))
    (open(os.path.join(root, "class_0", "notes.txt"), "w")).write("not an image")
    return root


def _assert_sample_equal(got, ref):
    (gi, gl), (ri, rl) = got, ref
    ri = np.asarray(ri)
    assert gi.dtype == np.float32 and ri.dtype == np.float32
    np.testing.assert_array_equal(gi, ri.transpose(2, 0, 1))
    assert int(gl) == int(rl)


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("cifar100", [False, True], ids=["cifar10", "cifar100"])
def test_cifar_samples_byte_equal_to_jax(tmp_path, train, cifar100):
    root = write_cifar(str(tmp_path), cifar100=cifar100)
    port_cls = datasets.CIFAR100Dataset if cifar100 else datasets.CIFAR10Dataset
    jax_cls = jax_datasets.CIFAR100Dataset if cifar100 else jax_datasets.CIFAR10Dataset
    got, ref = port_cls(root, train=train, seed=3), jax_cls(root, train=train, seed=3)
    assert len(got) == len(ref) == (16 if (cifar100 or not train) else 80)
    for i in list(range(len(ref))) * 2:  # twice: the crop and flip draws go on
        _assert_sample_equal(got[i], ref[i])


def test_cifar_reseed_sets_the_augmentation_stream(tmp_path):
    root = write_cifar(str(tmp_path))
    ds = datasets.CIFAR10Dataset(root, train=True)
    ds.reseed(2**40 + 7)  # a worker seed beyond 32 bits
    first = [ds[0][0] for _ in range(6)]
    ds.reseed(2**40 + 7)
    again = [ds[0][0] for _ in range(6)]
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert not all(np.array_equal(first[0], a) for a in first[1:])


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gzip"])
def test_mnist_samples_byte_equal_to_jax(tmp_path, gz):
    root = write_mnist(str(tmp_path), gz=gz)
    for train in (True, False):
        got, ref = datasets.MNISTDataset(root, train), jax_dataloaders.MNISTDataset(root, train)
        assert len(got) == len(ref) == (24 if train else 12)
        for i in range(len(ref)):
            (gi, gl), (ri, rl) = got[i], ref[i]
            assert gi.shape == (1, 28, 28) and gi.dtype == np.float32
            np.testing.assert_array_equal(gi, ri.transpose(2, 0, 1))
            assert gl == rl
    with pytest.raises(FileNotFoundError, match="MNIST file"):
        datasets.MNISTDataset(str(tmp_path / "missing"))


@pytest.mark.parametrize("with_transform", [False, True])
def test_image_folder_samples_byte_equal_to_jax(tmp_path, with_transform):
    root = write_image_folder(str(tmp_path))
    flip = (lambda img: img[:, ::-1]) if with_transform else None
    got = datasets.ImageFolderDataset(root, (32, 40), transforms=flip)
    ref = jax_datasets.ImageFolderDataset(root, (32, 40), transforms=flip)
    assert got.classes == ref.classes == ["class_0", "class_1", "class_2"]
    assert got.samples == ref.samples and len(got) == 9
    for i in range(len(ref)):
        assert got[i][0].shape == (3, 32, 40)
        _assert_sample_equal(got[i], ref[i])


def _batches(loader, n=None):
    out = []
    for i, (images, labels) in enumerate(loader):
        if n is not None and i == n:
            break
        out.append((np.asarray(images), np.asarray(labels)))
    return out


@pytest.mark.parametrize("name,params,kind", [
    ("cifar10_train", {"batch_size": 16}, "cifar10"),
    ("cifar10_val", {"batch_size": 12}, "cifar10"),
    ("cifar100_train", {"batch_size": 8}, "cifar100"),
    ("cifar100_val", {"batch_size": 8}, "cifar100"),
    ("mnist_train", {"batch_size": 8}, "mnist"),
    ("mnist_val", {"batch_size": 5}, "mnist"),
    ("imagenet_train", {"batch_size": 4, "image_size": (24, 24)}, "folder"),
    ("imagenet_val", {"batch_size": 4, "image_size": (24, 24)}, "folder"),
    ("classification_test_dataloader", {"batch_size": 8, "image_size": (16, 16), "dataset_size": 24}, None),
])
def test_named_loaders_match_jax_at_zero_workers(tmp_path, name, params, kind):
    """Two epochs of each registered loader: the JAX batches, images CHW, in the JAX order."""
    root = str(tmp_path)
    if kind == "cifar10":
        params = dict(params, root=write_cifar(root))
    elif kind == "cifar100":
        params = dict(params, root=write_cifar(root, cifar100=True))
    elif kind == "mnist":
        params = dict(params, root=write_mnist(root))
    elif kind == "folder":
        params = dict(params, data_dir=write_image_folder(root))
    ref_loader = jax_dataloaders.get(name, dataset_params=params)
    loader = dataloaders.get(name, dataset_params=params, dataloader_params={"num_workers": 0})
    assert loader.max_value is None  # float32 images: nothing to standardize on the device
    for epoch in range(2):
        ref_loader.set_epoch(epoch)
        loader.set_epoch(epoch)
        ref, got = _batches(ref_loader), _batches(loader)
        assert len(got) == len(ref) > 0
        for (gi, gl), (ri, rl) in zip(got, ref):
            np.testing.assert_array_equal(gi, ri.transpose(0, 3, 1, 2))
            np.testing.assert_array_equal(gl, rl)


def test_cifar10_train_batches_equal_for_equal_seeds_with_workers(tmp_path):
    root = write_cifar(str(tmp_path))

    def run(seed):
        loader = dataloaders.DataLoader(datasets.CIFAR10Dataset(root, train=True), batch_size=16, shuffle=True,
                                        seed=seed, num_workers=2)
        try:
            return _batches(loader)
        finally:
            del loader

    a, b, other = run(5), run(5), run(6)
    assert len(a) == len(b) == 5
    for (ai, al), (bi, bl) in zip(a, b):
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(al, bl)
    assert not all(np.array_equal(ai, oi) for (ai, _), (oi, _) in zip(a, other))


@pytest.mark.parametrize("seed", range(12))
def test_rand_augment_equal_to_jax(seed):
    """Two of the 14 PIL ops a call, drawn from the global ``random``; 12 seeds, 3 calls each."""
    image = np.random.RandomState(seed).randint(0, 256, (24, 30, 3), dtype=np.uint8)
    outs = {}
    for which, module in (("jax", jax_transforms), ("port", port_transforms)):
        random.seed(seed)
        t = module.RandAugment(num_ops=2, magnitude=5 + seed % 5)
        outs[which] = [t(image) for _ in range(3)]
    for got, ref in zip(outs["port"], outs["jax"]):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("value", ["random", "zero"])
def test_random_erase_equal_to_jax(value):
    image = np.random.RandomState(0).randint(0, 256, (32, 32, 3), dtype=np.uint8)
    outs = {}
    for which, module in (("jax", jax_transforms), ("port", port_transforms)):
        random.seed(1)
        np.random.seed(2)
        t = module.RandomErase(probability=0.7, value=value)
        outs[which] = [t(image) for _ in range(10)]
    erased = 0
    for got, ref in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(got, ref)
        erased += not np.array_equal(got, image)
    assert erased >= 3


@pytest.mark.parametrize("fn", ["mixup_batch", "cutmix_batch"])
def test_mixup_and_cutmix_equal_to_jax(fn):
    rng = np.random.RandomState(4)
    images = rng.rand(6, 16, 16, 3).astype(np.float32)
    labels = rng.randint(0, 5, 6)
    for seed in range(4):
        ref = getattr(jax_transforms, fn)(images, labels, 5, rng=np.random.RandomState(seed))
        got = getattr(port_transforms, fn)(images, labels, 5, rng=np.random.RandomState(seed))
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
        np.testing.assert_allclose(got[1].sum(-1), 1.0, rtol=1e-6)
