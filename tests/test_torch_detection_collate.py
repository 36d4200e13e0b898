"""The detection collate functions of the PyTorch port against the JAX package's.

``PPYoloECollateFN`` and its crowd variant draw a size and then an interpolation mode per
batch from ``np.random.RandomState(seed)`` and resize with ``cv2.resize`` where cv2
imports: the port's batches are byte-equal to the JAX package's on the same samples
(the port's images are ``[3, H, W]``, JAX's ``[H, W, 3]``), uint8 and float32. Without
cv2 both packages resize through PIL: held byte-equal too, the port under its
``cv2_module`` getter patched to None and the JAX package with ``cv2`` unimportable.
``PPYoloEMultiScaleCollate`` (the PP-YOLOE COCO loader's) is held to the JAX collate's
``jax.image.resize(..., "bilinear")`` of the standardized images within 5e-6, 1/800 of a grey level (both
antialias the downscale; they sum the filter taps in another order), its size schedule
and targets exactly.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from super_gradients_tpu.training import collate_functions as jcf
from super_gradients_tpu.training.dataloaders import PPYoloEMultiScaleCollate as JaxMultiScale
from super_gradients_tpu_torch.inference import processing
from super_gradients_tpu_torch.training import collate_functions as pcf
from super_gradients_tpu_torch.training.dataloaders import PPYoloEMultiScaleCollate

SIZES = [32, 48, 64]


@pytest.fixture
def no_cv2(monkeypatch):
    """No cv2 for either package: the port's getter returns None, the JAX import fails."""
    monkeypatch.setattr(processing, "cv2_module", lambda: None)
    monkeypatch.setitem(sys.modules, "cv2", None)


def samples(seed, n=3, hw=(40, 56), crowd=False, dtype=np.uint8):
    """(JAX samples [H, W, 3], port samples [3, H, W]) with padded targets."""
    rng = np.random.RandomState(seed)
    jax_s, port_s = [], []
    for _ in range(n):
        img = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
        if dtype != np.uint8:
            img = np.multiply(img, np.float32(1 / 255.0), dtype=np.float32)
        t = -np.ones((6, 5), np.float32)
        k = rng.randint(1, 5)
        xy = rng.uniform(0, 30, (k, 2))
        t[:k] = np.concatenate([rng.randint(0, 4, (k, 1)), xy, xy + rng.uniform(2, 20, (k, 2))], 1)
        extra = ()
        if crowd:
            c = -np.ones((3, 5), np.float32)
            c[0] = [1, 2.0, 3.0, 20.0, 25.0]
            extra = (c,)
        jax_s.append((img, t) + extra)
        port_s.append((np.ascontiguousarray(img.transpose(2, 0, 1)), t.copy()) + tuple(e.copy() for e in extra))
    return jax_s, port_s


def assert_batch_equal(got, ref):
    assert isinstance(got[0], torch.Tensor) and len(got) == len(ref)
    np.testing.assert_array_equal(got[0].permute(0, 2, 3, 1).numpy(), ref[0])
    assert got[0].dtype == torch.from_numpy(np.asarray(ref[0])).dtype
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), r)


def test_registry_names():
    assert sorted(pcf.COLLATE_FUNCTIONS) == sorted(jcf.COLLATE_FUNCTIONS) == [
        "CrowdDetectionCollateFN", "CrowdDetectionPPYoloECollateFN", "DetectionCollateFN", "PPYoloECollateFN"]


@pytest.mark.parametrize("crowd", [False, True])
def test_plain_collates_stack(crowd):
    js, ps = samples(0, crowd=crowd)
    name = "CrowdDetectionCollateFN" if crowd else "DetectionCollateFN"
    assert_batch_equal(pcf.COLLATE_FUNCTIONS[name]()(ps), jcf.COLLATE_FUNCTIONS[name]()(js))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("crowd", [False, True])
def test_ppyoloe_collate_byte_equal_under_cv2(crowd, dtype):
    name = "CrowdDetectionPPYoloECollateFN" if crowd else "PPYoloECollateFN"
    kw = dict(random_resize_sizes=SIZES, random_resize_modes=[0, 1, 2, 3, 4], seed=3)
    jfn, pfn = jcf.COLLATE_FUNCTIONS[name](**kw), pcf.COLLATE_FUNCTIONS[name](**kw)
    shapes = set()
    for seed in range(6):  # one draw sequence: six batches
        js, ps = samples(seed, crowd=crowd, dtype=dtype)
        ref, got = jfn(js), pfn(ps)
        assert_batch_equal(got, ref)
        shapes.add(tuple(got[0].shape[2:]))
    assert len(shapes) > 1


@pytest.mark.parametrize("crowd", [False, True])
def test_ppyoloe_collate_without_cv2_follows_jax_pil_path(no_cv2, crowd):
    name = "CrowdDetectionPPYoloECollateFN" if crowd else "PPYoloECollateFN"
    kw = dict(random_resize_sizes=SIZES, random_resize_modes=[0, 1, 2], seed=1)
    jfn, pfn = jcf.COLLATE_FUNCTIONS[name](**kw), pcf.COLLATE_FUNCTIONS[name](**kw)
    for seed in range(4):
        for dtype in (np.uint8, np.float32):
            js, ps = samples(seed, crowd=crowd, dtype=dtype)
            assert_batch_equal(pfn(ps), jfn(js))


@pytest.mark.parametrize("ratio", [False, True, (0.5, 1.0), [1.0, 2.0]])
def test_random_aspect_ratio_sizes_match_jax(ratio):
    kw = dict(random_resize_sizes=[320, 480, 640], random_aspect_ratio=ratio)
    got = pcf.PPYoloECollateFN(**kw).random_resize_sizes
    ref = jcf.PPYoloECollateFN(**kw).random_resize_sizes
    np.testing.assert_array_equal(got, ref)
    assert len(got) == {False: 3, True: 9}.get(ratio if isinstance(ratio, bool) else None, 6)
    js, ps = samples(4, hw=(40, 40))
    kw = dict(random_resize_sizes=SIZES, random_aspect_ratio=ratio, seed=2)
    jfn, pfn = jcf.PPYoloECollateFN(**kw), pcf.PPYoloECollateFN(**kw)
    for _ in range(3):
        assert_batch_equal(pfn(ps), jfn(js))


@pytest.mark.parametrize("ratio", [(2.0, 1.0), (5.0, 6.0), "wide"])
def test_bad_aspect_ratio_raises_as_jax(ratio):
    with pytest.raises(ValueError) as ref:
        jcf.PPYoloECollateFN(random_resize_sizes=[320, 480], random_aspect_ratio=ratio)
    with pytest.raises(ValueError) as got:
        pcf.PPYoloECollateFN(random_resize_sizes=[320, 480], random_aspect_ratio=ratio)
    assert str(got.value) == str(ref.value)


def test_without_sizes_collate_only_stacks():
    js, ps = samples(5)
    assert_batch_equal(pcf.PPYoloECollateFN()(ps), jcf.PPYoloECollateFN()(js))


def test_multiscale_collate_matches_jax_resize():
    """Six batches of uint8 640-wide samples: the port standardizes and resizes the batches
    whose height differs from the drawn size, as the JAX collate resizes its standardized
    float batches; a batch at its own size stays uint8 for the trainer to standardize."""
    jfn, pfn = JaxMultiScale(sizes=(32, 48, 64), seed=1), PPYoloEMultiScaleCollate(sizes=(32, 48, 64), seed=1)
    seen = []
    for seed in range(6):
        js, ps = samples(seed, n=2, hw=(64, 64))
        js = [(np.multiply(img, np.float32(1 / 255.0), dtype=np.float32), t) for img, t in js]
        ref, got = jfn(js), pfn(ps)
        seen.append(got[0].shape[2])
        np.testing.assert_array_equal(got[1].numpy(), ref[1])
        if got[0].dtype == torch.uint8:
            assert got[0].shape[2] == 64
            np.testing.assert_array_equal(got[0].float().mul_(float(np.float32(1 / 255.0))).permute(0, 2, 3, 1).numpy(),
                                          ref[0])
        else:
            assert got[0].shape == (2, 3, seen[-1], seen[-1])
            np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), ref[0], atol=5e-6, rtol=0)
    assert seen == [64, 32, 48, 64, 32, 48]


def test_multiscale_resize_is_jax_bilinear_of_wide_images():
    """Non-square batches: the width is ``round(w * scale)``, as in JAX."""
    x = np.random.RandomState(0).rand(2, 64, 90, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (2, 48, int(round(90 * 48 / 64)), 3), method="bilinear"))
    t = -np.ones((2, 4, 5), np.float32)
    fn = PPYoloEMultiScaleCollate(sizes=(48,), seed=0)
    got = fn([(np.ascontiguousarray(img.transpose(2, 0, 1)), tt) for img, tt in zip(x, t)])
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), ref, atol=5e-6, rtol=0)
