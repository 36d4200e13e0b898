"""The port's detection datasets and loaders against the JAX package's, on the CPU.

Datasets are written to a temporary directory: PNG images (by PIL) and COCO json,
YOLO-darknet txt and RF100 layouts. Targets (boxes, labels, crowd flags, padding)
must be exactly equal to the JAX dataset's. Images already at ``input_dim`` pass the
val chain untouched on both sides, so the port's uint8 image divided by its
``max_value`` (``DetectionStandardize``'s float32 product) is bit-equal to the JAX
float32 image. Through the mosaic train chain, with the JAX global generators and
the port dataset's own seeded alike, targets are exactly equal and images within 1
grey level (the JAX chain given the port's resize, as in
``tests/test_torch_detection_transforms.py``). The epoch order
(shuffle, ``drop_last``, ``min_samples``) equals the JAX ``DataLoader``'s index for
index; the device standardize of a uint8 batch equals the host's bit for bit.
"""

import json
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

from super_gradients_tpu.training import dataloaders as jax_loaders
from super_gradients_tpu.training import datasets as jax_datasets
from super_gradients_tpu.training import datasets_roboflow as jax_roboflow
from super_gradients_tpu_torch.common.registry import DATALOADERS
from super_gradients_tpu_torch.training import dataloaders, datasets, datasets_roboflow
from super_gradients_tpu_torch.training.trainer import _to_device
from super_gradients_tpu_torch.training.transforms.detection import DetectionPaddedRescale, DetectionStandardize
from test_torch_detection_transforms import same_resize, smooth_image  # noqa: F401  (a fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 64
CLASSES = ["cat", "dog", "car", "bus"]


def write_coco(folder, json_path, n, rng, sizes=((SIDE, SIDE),), empty=(), names=None):
    """Smooth PNG images and a COCO json: 1-6 boxes an image (category ids 10, 20, ...),
    one zero-area box and about 1 in 5 crowd; images in ``empty`` have no box."""
    os.makedirs(folder, exist_ok=True)
    images, anns = [], []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        name = (names or "{:03d}.png").format(i)
        Image.fromarray(smooth_image(rng, h, w)).save(os.path.join(folder, name))
        images.append({"id": 100 + i, "file_name": name, "height": h, "width": w})
        for _ in range(0 if i in empty else rng.randint(1, 7)):
            x, y = rng.uniform(0, w - 8), rng.uniform(0, h - 8)
            anns.append({"id": len(anns), "image_id": 100 + i, "category_id": 10 * (1 + rng.randint(4)),
                         "bbox": [x, y, rng.uniform(3, w - x), rng.uniform(3, h - y)],
                         "iscrowd": int(rng.rand() < 0.2)})
    anns.append({"id": len(anns), "image_id": 100, "category_id": 10, "bbox": [1.0, 1.0, 0.0, 5.0], "iscrowd": 0})
    cats = [{"id": 10 * (1 + k), "name": c} for k, c in enumerate(CLASSES)]
    with open(json_path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats[::-1]}, f)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("det"))
    rng = np.random.RandomState(0)
    rf = os.path.join(root, "rf100", "tiny")
    write_coco(os.path.join(rf, "train"), os.path.join(rf, "train", "_annotations.coco.json"), 10, rng,
               sizes=((48, 70), (64, 64), (40, 56), (72, 50)), empty=(3,))
    write_coco(os.path.join(rf, "valid"), os.path.join(rf, "valid", "_annotations.coco.json"), 6, rng, empty=(2,))
    coco = os.path.join(root, "coco")
    os.makedirs(os.path.join(coco, "annotations"))
    write_coco(os.path.join(coco, "images", "val2017"), os.path.join(coco, "annotations", "instances_val2017.json"),
               5, rng)
    yolo = os.path.join(root, "yolo")
    os.makedirs(os.path.join(yolo, "labels"))
    for i, (h, w) in enumerate(((30, 40), (SIDE, SIDE), (50, 20))):
        os.makedirs(os.path.join(yolo, "images"), exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(os.path.join(yolo, "images", f"{i}.png"))
        if i != 2:  # the third image has no label file
            rows = [f"{rng.randint(4)} {rng.uniform(0.3, 0.7):.4f} {rng.uniform(0.3, 0.7):.4f} 0.2 0.3" for _ in range(3)]
            with open(os.path.join(yolo, "labels", f"{i}.txt"), "w") as f:
                f.write("\n".join(rows + ["1 0.5"]))  # a short row is skipped
    return root


def val_chain(module):
    return [module.DetectionPaddedRescale(input_dim=(SIDE, SIDE)), module.DetectionStandardize(max_value=255.0)]


def assert_val_sample_equal(jax_ds, port_ds, i):
    """Port sample i == JAX sample i: targets exactly, the image as uint8 / max_value."""
    ref_image, ref_target = jax_ds[i]
    image, target = port_ds[i]
    np.testing.assert_array_equal(target, ref_target)
    assert image.dtype == np.uint8 and image.shape == (3, *ref_image.shape[:2])
    hwc = np.ascontiguousarray(image.transpose(1, 2, 0))
    np.testing.assert_array_equal(np.multiply(hwc, np.float32(1 / port_ds.max_value), dtype=np.float32), ref_image)


def _jax_transforms():
    from super_gradients_tpu.training.transforms import detection as jt

    return jt


def _port_transforms():
    from super_gradients_tpu_torch.training.transforms import detection as pt

    return pt


@pytest.mark.parametrize("kwargs", [dict(), dict(with_crowd=True), dict(ignore_empty_annotations=True),
                                    dict(class_inclusion_list=["dog", "bus"], with_crowd=True, max_boxes=3),
                                    dict(class_inclusion_list=["car"], ignore_empty_annotations=True)])
def test_roboflow_val_samples_equal_jax(data, kwargs):
    args = dict(data_dir=os.path.join(data, "rf100"), dataset_name="tiny", split="valid")
    ref = jax_roboflow.RoboflowDetectionDataset(**args, transforms=val_chain(_jax_transforms()), **kwargs)
    got = datasets_roboflow.RoboflowDetectionDataset(**args, transforms=val_chain(_port_transforms()), **kwargs)
    assert len(got) == len(ref) and got.classes == ref.classes and got.all_classes_list == ref.all_classes_list
    assert got.max_value == 255.0
    for i in range(len(ref)):
        assert_val_sample_equal(ref, got, i)
    np.testing.assert_array_equal(got.get_dataset_classes_information(), ref.get_dataset_classes_information())
    assert got.get_dataset_preprocessing_params()["class_names"] == ref.get_dataset_preprocessing_params()["class_names"]


def test_coco_and_coco_format_datasets_equal_jax(data):
    coco = os.path.join(data, "coco")
    ref = jax_datasets.COCODetectionDataset(coco, transforms=val_chain(_jax_transforms()), with_crowd=True)
    got = datasets.COCODetectionDataset(coco, transforms=val_chain(_port_transforms()), with_crowd=True)
    assert len(got) == len(ref) == 5
    for i in range(5):
        assert_val_sample_equal(ref, got, i)
    fmt = dict(data_dir=coco, json_annotation_file="annotations/instances_val2017.json", images_dir="images/val2017")
    ref = jax_datasets.COCOFormatDetectionDataset(**fmt, max_boxes=4)
    got = datasets.COCOFormatDetectionDataset(**fmt, max_boxes=4)
    assert got.max_value is None  # no trailing standardize: float32 images, as JAX leaves them
    for i in range(5):
        (ri, rt), (gi, gt) = ref[i], got[i]
        np.testing.assert_array_equal(gt, rt)
        assert gi.dtype == np.float32
        np.testing.assert_array_equal(gi.transpose(1, 2, 0), ri)


def test_yolo_darknet_dataset_equals_jax(data):
    args = dict(data_dir=os.path.join(data, "yolo"), images_dir="images", labels_dir="labels", classes=CLASSES,
                transforms=None, max_boxes=5)
    ref, got = jax_datasets.YoloDarknetFormatDetectionDataset(**args), datasets.YoloDarknetFormatDetectionDataset(**args)
    assert len(got) == len(ref) == 3
    for i in range(3):
        np.testing.assert_array_equal(got[i][1], ref[i][1])
        np.testing.assert_array_equal(got[i][0].transpose(1, 2, 0), ref[i][0])


@pytest.mark.parametrize("seed", [0, 5])
def test_mosaic_train_dataset_draws_as_jax(data, seed, same_resize):
    """The train chain through the dataset: the additional samples' indices (np.random)
    and every transform decision (random) as the JAX dataset draws them."""
    args = dict(data_dir=os.path.join(data, "rf100"), dataset_name="tiny", split="train", max_boxes=40)
    ref = jax_roboflow.RoboflowDetectionDataset(**args, transforms=jax_loaders._yolo_nas_train_transforms((SIDE, SIDE)))
    got = datasets_roboflow.RoboflowDetectionDataset(**args, seed=seed,
                                                     transforms=dataloaders._yolo_nas_train_transforms((SIDE, SIDE)))
    random.seed(seed)
    np.random.seed(seed)
    for i in (0, 4, 4, 9):
        ref_image, ref_target = ref[i]
        image, target = got[i]
        np.testing.assert_array_equal(target, ref_target)
        diff = np.abs(np.multiply(image.transpose(1, 2, 0), np.float32(1 / 255), dtype=np.float32) - ref_image) * 255
        assert diff.max() <= 1.001
    assert np.random.randint(1 << 30) == got.np_rng.randint(1 << 30) and random.random() == got.rng.random()


@pytest.mark.parametrize("n,batch,shuffle,drop_last,min_samples", [(10, 3, True, True, None), (10, 3, True, False, None),
                                                                   (10, 4, False, False, None), (5, 4, True, True, 12)])
def test_epoch_order_equals_jax(n, batch, shuffle, drop_last, min_samples):
    class Indices:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return np.int64(i)

    kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last, seed=3, min_samples=min_samples,
              collate_fn=np.asarray)
    ref, got = jax_loaders.DataLoader(Indices(), **kw), dataloaders.DataLoader(Indices(), **kw)
    assert len(got) == len(ref)
    for epoch in range(3):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        assert [b.tolist() for b in got] == [b.tolist() for b in ref]


def test_named_loaders_and_val_batches_equal_jax(data):
    params = dict(data_dir=os.path.join(data, "rf100"), dataset_name="tiny", image_size=[SIDE, SIDE])
    loader_params = {"batch_size": 4, "num_workers": 0}
    ref = jax_loaders.get("roboflow_val", dataset_params={**params, "batch_size": 32}, dataloader_params=loader_params)
    got = dataloaders.get("roboflow_val", dataset_params={**params, "batch_size": 32, "num_workers": 3},
                          dataloader_params=loader_params)
    assert got.batch_size == 4 and got.num_workers == 0 and got.max_value == 255.0 and len(got) == len(ref) == 2
    for (ri, rt), (gi, gt) in zip(ref, got):
        assert gi.dtype == torch.uint8 and gi.shape == (len(ri), 3, SIDE, SIDE)
        np.testing.assert_array_equal(gt.numpy(), rt)
        host = np.multiply(gi.permute(0, 2, 3, 1).numpy(), np.float32(1 / 255), dtype=np.float32)
        np.testing.assert_array_equal(host, ri)
    assert {"roboflow_train", "roboflow_val", "coco2017_train", "coco2017_train_yolo_nas", "coco2017_val",
            "coco2017_val_yolo_nas", "detection_test_dataloader"} <= set(DATALOADERS)
    train = dataloaders.get("roboflow_train", dataset_params=params, dataloader_params={"batch_size": 4})
    assert len(train) == len(jax_loaders.get("roboflow_train", dataset_params=params,
                                             dataloader_params={"batch_size": 4})) == 2
    test = dataloaders.get("detection_test_dataloader", dataset_params={"image_size": (32, 32), "dataset_size": 8},
                           dataloader_params={"batch_size": 4})
    images, targets = next(iter(test))
    jax_images, jax_targets = next(iter(jax_loaders.get("detection_test_dataloader", dataset_params={
        "image_size": (32, 32), "dataset_size": 8}, dataloader_params={"batch_size": 4})))
    np.testing.assert_array_equal(images.permute(0, 2, 3, 1).numpy(), jax_images)
    np.testing.assert_array_equal(targets.numpy(), jax_targets)


def test_workers_reseed_and_repeat(data):
    """Two loaders with one seed and 2 workers give equal batches; the workers' draws
    differ from the main process's (each worker reseeds from its worker seed). Run in a
    fresh interpreter: forking this one, which runs JAX's threads, could deadlock."""
    code = textwrap.dedent(
        f"""
        import torch
        from super_gradients_tpu_torch.training import dataloaders
        params = dict(data_dir={os.path.join(data, "rf100")!r}, dataset_name="tiny", image_size=[{SIDE}, {SIDE}])
        runs = []
        for workers in (2, 2, 0):
            loader = dataloaders.get("roboflow_train", dataset_params=params,
                                     dataloader_params={{"batch_size": 2, "num_workers": workers}})
            assert loader.persistent_workers == (workers > 0)
            runs.append([tuple(t.clone() for t in batch) for batch in loader])
            del loader
        assert all(torch.equal(a, b) for x, y in zip(runs[0], runs[1]) for a, b in zip(x, y))
        assert not all(torch.equal(a, b) for x, y in zip(runs[0], runs[2]) for a, b in zip(x, y))
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.startswith("OK"), proc.stderr[-3000:]


def test_standardize_on_the_device_is_bit_equal_to_the_host():
    rng = np.random.RandomState(9)
    images = torch.from_numpy(rng.randint(0, 256, (3, 3, 20, 24), dtype=np.uint8))
    targets = torch.from_numpy(rng.rand(3, 5, 5).astype(np.float32))
    for max_value in (255.0, 127.0):
        on_device, t = _to_device(images, targets, torch.device("cpu"), max_value)
        host = np.stack([DetectionStandardize(max_value)(
            DetectionPaddedRescale((20, 24))(_sample(im), None), None).image for im in images.permute(0, 2, 3, 1).numpy()])
        assert on_device.dtype == torch.float32 and torch.equal(t, targets)
        np.testing.assert_array_equal(on_device.permute(0, 2, 3, 1).numpy(), host)
    floats = images.float() / 7
    assert torch.equal(_to_device(floats, targets, torch.device("cpu"), 255.0)[0], floats)
    with pytest.raises(ValueError, match="max_value"):
        _to_device(images, targets, torch.device("cpu"))


def _sample(image):
    from super_gradients_tpu_torch.training.transforms.detection import DetectionSample

    return DetectionSample(image, np.zeros((0, 4), np.float32), np.zeros(0, np.int32))


def test_plot_and_missing_split_raise(data):
    with pytest.raises(ValueError, match="split"):
        datasets_roboflow.RoboflowDetectionDataset(os.path.join(data, "rf100"), "tiny", "val")
    ds = datasets_roboflow.RoboflowDetectionDataset(os.path.join(data, "rf100"), "tiny", "valid")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ds.plot()
    assert datasets_roboflow.get_dataset_num_classes("digits-t2eg6") == jax_roboflow.get_dataset_num_classes("digits-t2eg6")
    assert datasets_roboflow.list_datasets(["aerial"]) == jax_roboflow.list_datasets(["aerial"])
    assert datasets_roboflow.RF100_DATASETS == jax_roboflow.RF100_DATASETS
