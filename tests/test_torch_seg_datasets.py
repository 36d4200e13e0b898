"""The COCO, Pascal VOC, Mapillary and Supervisely segmentation datasets and their eight loaders
in the port, against the JAX package's, on seeded trees written in ``tmp_path`` by
``tools/segmentation_synthetic.py``.

- COCO's RLE: the compressed string decoder and the uncompressed runs equal JAX's and the mask
  they encode, at odd sizes (the column-major order shows there); polygon fill equal, a polygon
  of fewer than three points drawing nothing.
- Every sample of the four datasets equals JAX's byte for byte (the port's image CHW, as its
  other segmentation datasets): COCO with polygons, a compressed-RLE instance, an
  uncompressed-RLE crowd, a dropped crowd polygon, a dropped class outside the 21 and
  overlapping instances at an odd image size; VOC with its ``ImageSets`` list and without it
  (every mask present); Mapillary with 3-channel labels; Supervisely with csv rows whose files
  are missing.
- COCO keeps an image by its annotations' summed ``area``, not by its rendered pixels, in both
  packages (a fault of the JAX package kept in the port, ROADMAP.md section 3).
- The eight loaders by their JAX names and arguments, each with a batch, a validation batch
  equal to JAX's, ``shuffle`` and ``drop_last`` as JAX sets them.
- The COCO and Supervisely recipes and their group files load to the JAX ``load_recipe``'s dicts,
  and a recipe composing ``dataset_params: supervisely_persons_dataset_params`` resolves its
  ``defaults: - supervisely_dataset_params`` as the JAX loader does: not at all (nested
  defaults of a group file are read only as ``group: name`` entries).
"""

import json
import os

import numpy as np
import pytest
import torch

from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu.training import datasets_segmentation as jax_ds
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.training import dataloaders
from super_gradients_tpu_torch.training import datasets_segmentation as ds
from tools.segmentation_synthetic import (
    COCO_OTHER_CATEGORY_ID,
    encode_compressed_rle,
    uncompressed_rle,
    write_coco_segmentation_tree,
    write_mapillary_tree,
    write_supervisely_tree,
    write_voc_tree,
)

SIZE = (40, 24)  # the datasets' image_size: H x W


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg_trees")
    write_coco_segmentation_tree(str(root / "coco"), train=3, val=2, height=97, width=83, seed=1)
    write_supervisely_tree(str(root / "supervisely"), train=3, val=2, height=48, width=32, seed=2)
    write_voc_tree(str(root / "voc"), train=3, val=2, height=48, width=40, seed=3)
    write_voc_tree(str(root / "voc_no_sets"), train=2, val=1, height=48, width=40, seed=4, image_sets=False)
    write_mapillary_tree(str(root / "mapillary"), train=3, val=2, height=48, width=40, seed=5)
    return root


def test_rle_decoders_match_jax_at_odd_sizes():
    rng = np.random.RandomState(0)
    for h, w in ((7, 5), (33, 17), (1, 9), (64, 48)):
        for p in (0.0, 0.3, 0.97, 1.0):
            mask = (rng.rand(h, w) < p).astype(np.uint8)
            counts = encode_compressed_rle(mask)
            np.testing.assert_array_equal(ds.decode_compressed_rle(counts, h, w), mask)
            np.testing.assert_array_equal(jax_ds._decode_compressed_rle(counts, h, w), mask)
            rle = {"counts": uncompressed_rle(mask), "size": [h, w]}
            np.testing.assert_array_equal(ds.segmentation_to_mask(rle, h, w), mask)
            np.testing.assert_array_equal(jax_ds._segmentation_to_mask(rle, h, w), mask)


def test_polygon_fill_matches_jax():
    polygons = [[2.5, 3.0, 20.0, 4.0, 15.5, 18.0], [30.0, 2.0, 40.0, 2.0, 40.0, 12.0, 30.0, 12.0], [1.0, 1.0, 2.0, 2.0]]
    got = ds.segmentation_to_mask(polygons, 21, 43)
    np.testing.assert_array_equal(got, jax_ds._segmentation_to_mask(polygons, 21, 43))
    assert got.sum() > 100 and got[1, 1] == 0
    assert ds.segmentation_to_mask([polygons[2]], 21, 43).sum() == 0


def _datasets(trees, package):
    mod = ds if package == "port" else jax_ds
    return {
        "coco": mod.CoCoSegmentationDataset(str(trees / "coco"), "images/train2017", "instances_train2017.json",
                                            image_size=SIZE, min_pixels=100),
        "voc": mod.PascalVOC2012SegmentationDataset(str(trees / "voc"), "train", SIZE),
        "voc_no_sets": mod.PascalVOC2012SegmentationDataset(str(trees / "voc_no_sets"), "train", SIZE),
        "mapillary": mod.MapillaryDataset(str(trees / "mapillary"), image_size=SIZE),
        "supervisely": mod.SuperviselyPersonsDataset(str(trees / "supervisely"), "train.csv", SIZE),
    }


@pytest.mark.parametrize("name", ["coco", "voc", "voc_no_sets", "mapillary", "supervisely"])
def test_samples_equal_jax_byte_for_byte(trees, name):
    port, ref = _datasets(trees, "port")[name], _datasets(trees, "jax")[name]
    assert len(port) == len(ref) > 0 and list(port.classes) == list(ref.classes)
    for i in range(len(port)):
        (pi, pm), (ji, jm) = port[i], ref[i]
        assert pi.dtype == ji.dtype == np.float32 and pm.dtype == jm.dtype == np.int32
        assert pi.shape == (3, *SIZE) and pm.shape == SIZE
        np.testing.assert_array_equal(pi.transpose(1, 2, 0), ji)
        np.testing.assert_array_equal(pm, jm)


def test_each_tree_has_what_its_dataset_must_handle(trees):
    """The features the byte-equality runs over are there: COCO's dropped crowd polygons and
    foreign class, kept crowd RLEs and overlaps; VOC's fallback list; Mapillary's RGB labels;
    Supervisely's missing rows."""
    data = _datasets(trees, "port")
    coco = data["coco"]
    kept = [a for _, anns in coco.items for a in anns]
    assert not any(a["iscrowd"] and isinstance(a["segmentation"], list) for a in kept)
    assert not any(a["category_id"] == COCO_OTHER_CATEGORY_ID for a in kept)
    assert any(isinstance(a["segmentation"], dict) and isinstance(a["segmentation"]["counts"], str) for a in kept)
    assert any(a["iscrowd"] and isinstance(a["segmentation"], dict) for a in kept)
    first, second = kept[0], kept[1]  # the second polygon overlaps the first: the first keeps the shared pixels
    m1, m2 = (ds.segmentation_to_mask(a["segmentation"], 97, 83) for a in (first, second))
    rendered = coco.render_mask([first, second], 97, 83)
    both = (m1 > 0) & (m2 > 0)
    assert both.any() and (rendered[both] == coco.cat_to_idx[first["category_id"]]).all()
    assert data["voc_no_sets"].names == sorted(n[:-4] for n in os.listdir(trees / "voc_no_sets" / "SegmentationClass"))
    from PIL import Image

    label = Image.open(trees / "mapillary" / "training" / "v1.2" / "labels" / (data["mapillary"].names[0] + ".png"))
    assert label.mode == "RGB"
    with open(trees / "supervisely" / "train.csv") as f:
        assert len(f.read().splitlines()) == len(data["supervisely"]) + 1


def test_coco_keeps_images_by_annotation_area_in_both_packages(tmp_path):
    """A fault of the JAX package kept in the port: an image is kept when its annotations'
    ``area`` fields sum above ``min_pixels``, whatever their rendered masks hold."""
    os.makedirs(tmp_path / "images" / "val2017")
    from PIL import Image

    for i in (1, 2):
        Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(tmp_path / "images" / "val2017" / f"{i}.jpg")
    tiny = [[1.0, 1.0, 4.0, 1.0, 4.0, 4.0]]  # a few pixels, but an area field of 5000
    large = [[0.0, 0.0, 31.0, 0.0, 31.0, 31.0, 0.0, 31.0]]  # ~1000 pixels, but an area field of 10
    coco = {"images": [{"id": i, "file_name": f"{i}.jpg", "height": 32, "width": 32} for i in (1, 2)],
            "annotations": [{"id": 1, "image_id": 1, "category_id": 1, "segmentation": tiny, "area": 5000},
                            {"id": 2, "image_id": 2, "category_id": 1, "segmentation": large, "area": 10}]}
    with open(tmp_path / "instances_val2017.json", "w") as f:
        json.dump(coco, f)
    for package in (ds, jax_ds):
        dataset = package.CoCoSegmentationDataset(str(tmp_path), image_size=(32, 32), min_pixels=500)
        assert [img_id for img_id, _ in dataset.items] == [1]
        assert int((dataset[0][1] > 0).sum()) < 500


LOADERS = {  # name: (data root in the trees, root argument)
    "coco_segmentation_train": ("coco", "data_dir"), "coco_segmentation_val": ("coco", "data_dir"),
    "pascal_voc_segmentation_train": ("voc", "root"), "pascal_voc_segmentation_val": ("voc", "root"),
    "mapillary_train": ("mapillary", "root_dir"), "mapillary_val": ("mapillary", "root_dir"),
    "supervisely_persons_train": ("supervisely", "root_dir"), "supervisely_persons_val": ("supervisely", "root_dir"),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_loaders_by_name(trees, name):
    """A batch of each loader; the train loaders shuffle and drop their last batch, the val
    loaders neither, as JAX's; a val batch equals JAX's."""
    folder, key = LOADERS[name]
    params = {key: str(trees / folder), "batch_size": 2, "image_size": list(SIZE)}
    port, ref = dataloaders.get(name, dataset_params=params), jax_dataloaders.get(name, dataset_params=params)
    train = name.endswith("_train")
    assert (port.drop_last, port.order.shuffle) == (ref.drop_last, ref.shuffle) == (train, train)
    images, masks = next(iter(port))
    assert images.dtype == torch.float32 and images.shape == (2, 3, *SIZE)
    assert masks.dtype == torch.int32 and masks.shape == (2, *SIZE)
    if not train:
        j_images, j_masks = next(iter(ref))
        np.testing.assert_array_equal(images.numpy().transpose(0, 2, 3, 1), np.asarray(j_images))
        np.testing.assert_array_equal(masks.numpy(), np.asarray(j_masks))


RECIPE_FILES = ["coco_segmentation_shelfnet_lw", "supervisely_unet"]


@pytest.mark.parametrize("name", RECIPE_FILES)
def test_recipes_load_as_in_jax(name):
    got = config.load_recipe(name, overrides=["epochs=1"])
    assert got == jax_config.load_recipe(name, overrides=["epochs=1"])


def test_dataset_params_group_chain_resolves_as_in_jax(tmp_path):
    """Composed under ``dataset_params``, every COCO, VOC, Mapillary and Supervisely group file gives
    JAX's dict; the Supervisely-Persons file's bare ``defaults: - supervisely_dataset_params`` is not merged by
    either loader (the dataloader batch sizes of ``supervisely_dataset_params`` stay out)."""
    groups = ["coco_segmentation_dataset_params", "pascal_voc_segmentation_dataset_params",
              "pascal_aug_segmentation_dataset_params", "mapillary_dataset_params", "supervisely_dataset_params",
              "supervisely_persons_dataset_params"]
    for group in groups:
        (tmp_path / f"{group}_recipe.yaml").write_text(
            f"defaults:\n  - training_hyperparams: supervisely_default_train_params\n  - dataset_params: {group}\n"
            f"  - _self_\narchitecture: unet\n")
        got = config.load_recipe(f"{group}_recipe", config_dir=str(tmp_path))
        assert got == jax_config.load_recipe(f"{group}_recipe", config_dir=str(tmp_path)), group
    persons = got["dataset_params"]
    assert persons == {"train_dataset_params": {"root_dir": "/data/supervisely-persons", "list_file": "train.csv"},
                       "val_dataset_params": {"root_dir": "/data/supervisely-persons", "list_file": "val.csv"}}
    assert got["training_hyperparams"]["loss"] == "BCEDiceLoss" and got["training_hyperparams"]["initial_lr"] == 0.0025
