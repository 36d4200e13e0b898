"""The segmentation data and predict surface of the PyTorch port against the JAX package's.

Datasets and loaders read seeded PNG trees (``tools/cityscapes_synthetic.py`` for the
Cityscapes layout, paired ``images/`` + ``masks/`` folders) and must give the JAX
samples byte for byte (the port's images CHW). The segmentation processing steps are
byte-equal to JAX's where cv2 imports; without it (the ``no_cv2`` fixture) the bilinear
stand-in is within one grey level and the nearest one equals cv2's ``INTER_NEAREST``.
``SegmentationModel.predict`` gives JAX's class maps (shape, dtype, values) on the same
weights, and ``SegmentationPrediction.draw`` JAX's drawing, byte for byte.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.inference import prediction_results as jax_results
from super_gradients_tpu.inference import processing as jax_processing
from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu.training import datasets as jax_datasets
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.inference import processing
from super_gradients_tpu_torch.inference.prediction_results import SegmentationPrediction
from super_gradients_tpu_torch.training import dataloaders, datasets
from tools.cityscapes_synthetic import EVALUATED_LABEL_IDS, write_cityscapes_tree
from torch_jax_init import jax_model

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cityscapes_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes"))
    write_cityscapes_tree(root, train=5, val=3, height=48, width=96, seed=3)
    return root


def write_paired_folders(root, n=3, hw=(40, 56), seed=4):
    """``root/images/<i>.png`` and ``root/masks/<i>.png`` (class ids 0-5 and 255)."""
    rng = np.random.RandomState(seed)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, hw + (3,), dtype=np.uint8)).save(os.path.join(root, "images", f"{i}.png"))
        mask = rng.choice([0, 1, 2, 3, 4, 5, 255], hw).astype(np.uint8)
        Image.fromarray(mask).save(os.path.join(root, "masks", f"{i}.png"))
    return root


def test_synthetic_tree_covers_every_train_id_and_void(cityscapes_root):
    ds = datasets.CityscapesDataset(cityscapes_root, "train", image_size=(48, 96))
    seen = set()
    for i in range(len(ds)):
        seen |= set(np.unique(ds[i][1]).tolist())
    assert seen == set(range(19)) | {255}
    assert len(EVALUATED_LABEL_IDS) == 19 and sorted(datasets.CITYSCAPES_ID_TO_TRAIN_ID) == list(EVALUATED_LABEL_IDS)


@pytest.mark.parametrize("split,image_size", [("train", (32, 64)), ("val", (48, 96)), ("val", (30, 50))])
def test_cityscapes_samples_byte_equal_to_jax(cityscapes_root, split, image_size):
    """Image bilinear-resized / 255.0 in float32, mask nearest-resized, the labelId ->
    trainId table applied (void 255)."""
    ref = jax_datasets.CityscapesDataset(cityscapes_root, split, image_size=image_size)
    got = datasets.CityscapesDataset(cityscapes_root, split, image_size=image_size)
    assert len(got) == len(ref) == (5 if split == "train" else 3)
    assert [p for p in got.pairs] == [p for p in ref.pairs]
    for i in range(len(got)):
        (gi, gm), (ri, rm) = got[i], ref[i]
        assert gi.dtype == np.float32 and gi.shape == (3, *image_size) and gm.dtype == np.int32
        np.testing.assert_array_equal(gi, np.transpose(ri, (2, 0, 1)))
        np.testing.assert_array_equal(gm, rm)
    np.testing.assert_array_equal(got._lut, ref._lut)


def test_segmentation_dataset_byte_equal_to_jax(tmp_path):
    root = write_paired_folders(str(tmp_path))
    for image_size in ((40, 56), (32, 48)):
        ref = jax_datasets.SegmentationDataset(root, image_size=image_size)
        got = datasets.SegmentationDataset(root, image_size=image_size)
        assert got.items == ref.items and len(got) == 3
        for i in range(len(got)):
            (gi, gm), (ri, rm) = got[i], ref[i]
            np.testing.assert_array_equal(gi, np.transpose(ri, (2, 0, 1)))
            np.testing.assert_array_equal(gm, rm)
            assert gm.dtype == np.int32 and 255 in gm


SEG_LOADERS = ["segmentation_test_dataloader", "segmentation_train", "segmentation_val", "cityscapes_stdc_seg50_train",
               "cityscapes_stdc_seg50_val", "cityscapes_train", "cityscapes_val"] + [
    f"cityscapes_{n}_{s}" for n in ("seg50", "seg75", "ddrnet", "regseg48", "segformer") for s in ("train", "val")]


def test_loader_names_registered_as_in_jax():
    from super_gradients_tpu.common.registry import DATALOADERS as JAX_DATALOADERS

    for name in SEG_LOADERS:
        assert name in dataloaders.DATALOADERS and name in JAX_DATALOADERS, name


def test_stdc_seg50_alias_reads_paired_folders_in_both_packages(tmp_path, cityscapes_root):
    """The JAX package registers ``cityscapes_stdc_seg50_*`` as the paired image / mask
    folder loader, not the Cityscapes layout; the port keeps that (a JAX fault, ROADMAP.md
    section 3): on a Cityscapes tree both raise, on paired folders both read the pairs."""
    params = {"root": cityscapes_root, "batch_size": 2, "image_size": (32, 64)}
    for get in (dataloaders.get, jax_dataloaders.get):
        with pytest.raises(FileNotFoundError):
            get("cityscapes_stdc_seg50_train", dataset_params=params)
    root = write_paired_folders(str(tmp_path))
    params = {"root": root, "batch_size": 2, "image_size": (40, 56)}
    got = dataloaders.get("cityscapes_stdc_seg50_val", dataset_params=params)
    ref = jax_dataloaders.get("cityscapes_stdc_seg50_val", dataset_params=params)
    assert isinstance(got.dataset, datasets.SegmentationDataset)
    assert isinstance(ref.dataset, jax_datasets.SegmentationDataset)


@pytest.mark.parametrize("name,image_size", [("cityscapes_seg50_train", None), ("cityscapes_seg75_val", None),
                                             ("cityscapes_train", (32, 64)), ("cityscapes_val", (32, 64)),
                                             ("cityscapes_ddrnet_val", (24, 48))])
def test_cityscapes_loaders_match_jax(cityscapes_root, name, image_size):
    """Batches equal to the JAX loader's, in its order (a train loader shuffles from the
    seed and drops its last partial batch); the registered default sizes where none is given."""
    params = {"root": cityscapes_root, "batch_size": 2}
    if image_size is not None:
        params["image_size"] = image_size
    got = dataloaders.get(name, dataset_params=params)
    ref = jax_dataloaders.get(name, dataset_params=params)
    got_batches, ref_batches = list(got), list(ref)
    # 5 train images in 2 full batches (the last one dropped), 3 val images in 2 batches
    assert len(got_batches) == len(ref_batches) == 2
    for (gi, gm), (ri, rm) in zip(got_batches, ref_batches):
        np.testing.assert_array_equal(gi.numpy(), np.transpose(np.asarray(ri), (0, 3, 1, 2)))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    assert got.dataset.image_size == ref.dataset.image_size and got.max_value is None


def test_random_segmentation_dataset_matches_jax():
    got = dataloaders.RandomSegmentationDataset(4, (16, 24), 7, seed=2)
    ref = jax_dataloaders.RandomSegmentationDataset(4, (16, 24), 7, seed=2)
    for i in range(4):
        np.testing.assert_array_equal(got[i][0], np.transpose(ref[i][0], (2, 0, 1)))
        np.testing.assert_array_equal(got[i][1], ref[i][1])
    loader = dataloaders.get("segmentation_test_dataloader", dataset_params={"image_size": (16, 24), "batch_size": 4})
    images, masks = next(iter(loader))
    assert images.shape == (4, 3, 16, 24) and masks.shape == (4, 16, 24) and masks.dtype == torch.int32


# ------------------------------------------------------------------ processing


def _request(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,), dtype=np.uint8) for hw in ((70, 110), (64, 128), (90, 60), (33, 47))]


PROCESSING_PAIRS = {
    "ResizeWithPadding": lambda m: m.SegmentationResizeWithPadding((64, 128), pad_value=0),
    "Rescale_factor": lambda m: m.SegmentationRescale(scale_factor=0.7),
    "Rescale_short": lambda m: m.SegmentationRescale(short_size=40),
    "Rescale_long": lambda m: m.SegmentationRescale(long_size=100),
    "Resize": lambda m: m.SegmentationResize((48, 80)),
    "PadShortToCropSize": lambda m: m.SegmentationPadShortToCropSize((80, 100), fill_image=0),
    "PadToDivisible": lambda m: m.SegmentationPadToDivisible(32),
    "cityscapes": lambda m: m.default_cityscapes_processing_params(scale=0.0625)["image_processor"],
}


@pytest.mark.parametrize("name", list(PROCESSING_PAIRS))
def test_segmentation_processing_byte_equal_to_jax(name):
    """Preprocessed images and the class maps undone to the image's size, with cv2."""
    got_step, ref_step = PROCESSING_PAIRS[name](processing), PROCESSING_PAIRS[name](jax_processing)
    rng = np.random.RandomState(20)
    for image in _request(21):
        got, got_meta = got_step.preprocess_image(image)
        ref, ref_meta = ref_step.preprocess_image(image)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        seg = rng.randint(0, 19, got.shape[:2]).astype(np.int32)
        got_seg = got_step.postprocess_segmentation(seg, got_meta)
        ref_seg = ref_step.postprocess_segmentation(seg, ref_meta)
        assert got_seg.dtype == ref_seg.dtype
        np.testing.assert_array_equal(got_seg, ref_seg)


@pytest.fixture
def no_cv2(monkeypatch):
    """The port's no-cv2 path: its cv2 getter returns None (the JAX package keeps cv2)."""
    monkeypatch.setattr(processing, "cv2_module", lambda: None)


def test_no_cv2_stand_ins(no_cv2):
    """The bilinear stand-in within one grey level of cv2; the nearest stand-in equal to
    cv2's ``INTER_NEAREST`` (the floor rule), shrinking and enlarging."""
    import cv2

    rng = np.random.RandomState(22)
    for image in _request(23):
        got, _ = processing.SegmentationResize((48, 80)).preprocess_image(image)
        ref, _ = jax_processing.SegmentationResize((48, 80)).preprocess_image(image)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    for src, dst in (((48, 80), (70, 110)), ((64, 128), (33, 47)), ((17, 29), (17, 29)), ((96, 96), (1024, 2048))):
        seg = rng.randint(0, 19, src).astype(np.uint8)
        ref = cv2.resize(seg, dsize=(dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
        got = processing.resize_nearest(seg, dst)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------------ predict


def carried_pair(name, **kw):
    """(JAX model, port model on the CPU) carrying the port model's weights."""
    pm = models.get(name, device="cpu", **kw)
    jm = jax_model(name, **kw)
    sd = {k: v.numpy() for k, v in pm.net.state_dict().items()}
    mapper = tc.ppliteseg_key_mapper if name.startswith("pp_lite") else tc.stdc_key_mapper
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, tc.convert_state_dict(sd, jm.variables, mapper())))
    return jm, pm


@pytest.fixture(scope="module", params=[("pp_lite_t_seg", (64, 128)), ("stdc1_seg", (64, 64))],
                ids=["pp_lite_t_64x128", "stdc1_64x64"])
def predict_pair(request):
    name, input_hw = request.param
    return carried_pair(name, num_classes=6, input_hw=input_hw)


def _assert_same_maps(got, ref, images):
    assert len(got) == len(ref) == len(images)
    for g, r, img in zip(got, ref, images):
        assert g.segmentation_map.shape == r.segmentation_map.shape == np.asarray(img).shape[:2]
        assert g.segmentation_map.dtype == r.segmentation_map.dtype
        np.testing.assert_array_equal(g.segmentation_map, r.segmentation_map)


@pytest.mark.parametrize("batch_size", [3, 4])
def test_predict_matches_jax(predict_pair, batch_size):
    """Class maps equal to JAX's on non-square uint8 arrays and one at the input size, the
    last batch padded. The non-square model's maps come back through cv2's nearest resize
    (uint8); the square one's through PIL's nearest fallback (uint8), or at the input size
    as they are (int32), as in JAX."""
    jm, pm = predict_pair
    square = isinstance(pm._processing.processings[0], processing.ClassificationResize)
    hw = (pm._processing.processings[0].size,) * 2 if square else pm._processing.processings[0].output_shape
    images = _request(24) + [np.random.RandomState(25).randint(0, 256, (*hw, 3), dtype=np.uint8)]
    got, ref = pm.predict(images, batch_size=batch_size), jm.predict(images, batch_size=batch_size)
    _assert_same_maps(got, ref, images)
    assert all(g.image is img for g, img in zip(got, images))
    assert got[0].segmentation_map.dtype == np.uint8
    assert got[-1].segmentation_map.dtype == (np.int32 if square else np.uint8)


def test_predict_pil_image_and_file(predict_pair, tmp_path):
    jm, pm = predict_pair
    images = _request(26)[:2]
    for i, img in enumerate(images):
        Image.fromarray(img).save(tmp_path / f"{i}.png")
    _assert_same_maps(pm.predict(str(tmp_path / "0.png")), jm.predict(str(tmp_path / "0.png")), images[:1])
    _assert_same_maps(pm.predict(str(tmp_path)), jm.predict(str(tmp_path)), images)
    pil = Image.fromarray(images[1])
    _assert_same_maps(pm.predict(pil), jm.predict(pil), images[1:])


def test_predict_without_cv2_keeps_the_maps(predict_pair, no_cv2):
    """The no-cv2 stand-ins move the input by at most a grey level: the maps keep their
    shape and dtype and nearly all of their pixels."""
    jm, pm = predict_pair
    images = _request(27)
    got, ref = pm.predict(images), jm.predict(images)
    for g, r in zip(got, ref):
        assert g.segmentation_map.shape == r.segmentation_map.shape and g.segmentation_map.dtype == r.segmentation_map.dtype
        assert (g.segmentation_map == r.segmentation_map).mean() > 0.9


def test_class_map_reaches_the_host_in_the_narrowest_type():
    from super_gradients_tpu_torch.models.sg_model import smallest_int_dtype

    assert smallest_int_dtype(19) == torch.uint8 and smallest_int_dtype(256) == torch.uint8
    assert smallest_int_dtype(257) == torch.int16 and smallest_int_dtype(40000) == torch.int32
    pm = models.get("pp_lite_t_seg", num_classes=3, input_hw=(64, 64), device="cpu")
    maps = pm._class_maps(torch.zeros(1, 64, 64, 3))
    assert maps.dtype == torch.uint8 and maps.shape == (1, 64, 64)


@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_draw_byte_equal_to_jax(alpha, tmp_path):
    rng = np.random.RandomState(28)
    seg = rng.randint(0, 25, (30, 40))
    image = rng.randint(0, 256, (30, 40, 3), dtype=np.uint8)
    for img in (image, None):
        got = SegmentationPrediction(segmentation_map=seg, image=img).draw(alpha=alpha)
        ref = jax_results.SegmentationPrediction(segmentation_map=seg, image=img).draw(alpha=alpha)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
    SegmentationPrediction(segmentation_map=seg, image=image).save(str(tmp_path / "seg.png"), alpha=alpha)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "seg.png")),
                                  SegmentationPrediction(segmentation_map=seg, image=image).draw(alpha=alpha))
