"""The port's segmentation transforms against the JAX package's, byte for byte.

Each JAX transform draws from the module-level ``random`` seeded with ``random.seed(s)``;
its port takes ``random.Random(s)``. For every transform, seed and input the image and mask
must be byte-equal (same dtype and shape) and the two generators must stand at the same
place afterwards (the next draw equal), so a chain draws in the JAX order. Inputs are a
seeded float32 image with fractional values (PIL's uint8 round trip truncates them as in
JAX) and an int32 mask of 19 classes and void.
"""

import random

import numpy as np
import pytest

from super_gradients_tpu.common.registry import TRANSFORMS as JAX_TRANSFORMS
from super_gradients_tpu.training.transforms import segmentation as jseg
from super_gradients_tpu_torch.training.transforms import segmentation as pseg

SEEDS = range(6)


def _sample(seed, h=48, w=64):
    rng = np.random.RandomState(100 + seed)
    image = (rng.rand(h, w, 3) * 255).astype(np.float32)
    mask = rng.randint(0, 19, (h, w)).astype(np.int32)
    mask[rng.rand(h, w) < 0.1] = 255
    return image, mask


def _run_both(name, kwargs, seed, h=48, w=64):
    image, mask = _sample(seed, h, w)
    random.seed(seed)
    ref = getattr(jseg, name)(**kwargs)(jseg.SegSample(image.copy(), mask.copy()))
    ref_next = random.random()
    rng = random.Random(seed)
    got = getattr(pseg, name)(**kwargs)(pseg.SegSample(image.copy(), mask.copy()), rng)
    return ref, got, ref_next, rng.random()


def _assert_same(ref, got):
    for r, g in ((ref.image, got.image), (ref.mask, got.mask)):
        assert r.dtype == g.dtype and r.shape == g.shape
        np.testing.assert_array_equal(g, r)


CASES = [  # transform, kwargs
    ("SegResize", dict(h=37, w=53)),
    ("SegRandomFlip", dict(prob=0.5)),
    ("SegRescale", dict(scale_factor=0.7)),
    ("SegRescale", dict(short_size=40)),
    ("SegRescale", dict(long_size=50)),
    ("SegRescale", dict()),
    ("SegRandomRescale", dict(scales=(0.5, 1.5))),
    ("SegRandomRescale", dict(scales=2.0)),
    ("SegRandomRescale", dict(scales=(1.5, 0.75))),
    ("SegRandomRotate", dict(min_deg=-30, max_deg=30, fill_mask=255, fill_image=(10, 200, 30))),
    ("SegRandomRotate", dict(min_deg=-30, max_deg=30, fill_mask=7, fill_image=128)),
    ("SegCropImageAndMask", dict(crop_size=(30, 40), mode="random")),
    ("SegCropImageAndMask", dict(crop_size=(30, 80), mode="random")),
    ("SegCropImageAndMask", dict(crop_size=33, mode="center")),
    ("SegRandomGaussianBlur", dict(prob=0.5, sigma=(0.1, 2.0))),
    ("SegPadShortToCropSize", dict(crop_size=(81, 90), fill_mask=255, fill_image=(11, 22, 33))),
    ("SegPadShortToCropSize", dict(crop_size=(57, 40), fill_mask=0, fill_image=9)),
    ("SegPadShortToCropSize", dict(crop_size=64, fill_image=0)),
    ("SegPadShortToCropSize", dict(crop_size=(20, 20))),
    ("SegPadToDivisible", dict(divisible_value=20)),
    ("SegPadToDivisible", dict(divisible_value=16, fill_mask=3)),
    ("SegColorJitter", dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1)),
    ("SegColorJitter", dict(brightness=0.5, hue=0.3)),
    ("SegColorJitter", dict(contrast=1.5, saturation=0.2)),
    ("SegStandardize", dict()),
    ("SegStandardize", dict(max_value=127.5)),
    ("SegNormalize", dict()),
    ("SegNormalize", dict(mean=(0.2, 0.3, 0.4), std=(0.5, 0.6, 0.7))),
]


@pytest.mark.parametrize("name,kwargs", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_transform_is_byte_equal_to_jax(name, kwargs):
    """Every seed gives the JAX sample byte for byte and leaves the generator where JAX's is."""
    for seed in SEEDS:
        ref, got, ref_next, got_next = _run_both(name, kwargs, seed)
        _assert_same(ref, got)
        assert got_next == ref_next, (name, seed)


def test_random_transforms_reach_both_outcomes():
    """The fixtures reach both branches of each coin flip (flip and blur taken and skipped)
    and every draw of the jitter's order: over the seeds the four operations run in more
    than one order."""
    for name in ("SegRandomFlip", "SegRandomGaussianBlur"):
        changed = set()
        for seed in SEEDS:
            image, _ = _sample(seed)
            _, got, _, _ = _run_both(name, dict(prob=0.5), seed)
            changed.add(not np.array_equal(got.image, image))
        assert changed == {True, False}, name
    orders = set()
    for seed in SEEDS:
        rng = random.Random(seed)
        ops = ["b", "c", "s", "h"]
        rng.shuffle(ops)
        orders.add(tuple(ops))
    assert len(orders) > 1


def test_rotate_fills_exposed_pixels():
    """A 45-degree rotation exposes the corners: the image takes ``fill_image`` there and the
    mask ``fill_mask``, in both packages."""
    image, mask = _sample(0)
    t = dict(min_deg=45, max_deg=45, fill_mask=255, fill_image=(10, 200, 30))
    ref = jseg.SegRandomRotate(**t)(jseg.SegSample(image, mask))
    got = pseg.SegRandomRotate(**t)(pseg.SegSample(image, mask), random.Random(0))
    _assert_same(ref, got)
    np.testing.assert_array_equal(got.image[0, 0], [10, 200, 30])
    assert got.mask[0, 0] == 255 and got.mask[-1, -1] == 255


def test_random_rescale_rejects_non_positive_scales_as_jax():
    for bad in ((0.0, 1.0), (-1.0, 2.0)):
        with pytest.raises(ValueError):
            jseg.SegRandomRescale(bad)
        with pytest.raises(ValueError):
            pseg.SegRandomRescale(bad)
    for package in (jseg, pseg):
        with pytest.raises(ValueError):
            package.SegCropImageAndMask(10, mode="corner")


CHAIN = [("SegRandomRescale", dict(scales=(0.6, 1.4))), ("SegRandomRotate", dict(min_deg=-15, max_deg=15)),
         ("SegRandomFlip", dict(prob=0.5)), ("SegColorJitter", dict(brightness=0.3, contrast=0.3, saturation=0.3)),
         ("SegRandomGaussianBlur", dict(prob=0.5)), ("SegPadShortToCropSize", dict(crop_size=(56, 72))),
         ("SegCropImageAndMask", dict(crop_size=(56, 72))), ("SegPadToDivisible", dict(divisible_value=32)),
         ("SegStandardize", dict()), ("SegNormalize", dict())]


@pytest.mark.parametrize("pair", [False, True], ids=["sample", "image_mask_pair"])
def test_compose_chain_is_byte_equal_to_jax(pair):
    """``SegCompose`` of a training chain over a sample or an ``(image, mask)`` pair: the same
    kind comes back, byte-equal to JAX's, and the generators stay in step."""
    for seed in SEEDS:
        image, mask = _sample(seed)
        jchain = jseg.SegCompose([getattr(jseg, n)(**k) for n, k in CHAIN])
        pchain = pseg.SegCompose([getattr(pseg, n)(**k) for n, k in CHAIN])
        random.seed(seed)
        rng = random.Random(seed)
        if pair:
            ref = jseg.SegSample(*jchain(image, mask))
            out = pchain(image, mask, rng=rng)
            assert isinstance(out, tuple)
            got = pseg.SegSample(*out)
        else:
            ref = jchain(jseg.SegSample(image, mask))
            got = pchain(pseg.SegSample(image, mask), rng=rng)
            assert isinstance(got, pseg.SegSample)
        _assert_same(ref, got)
        assert got.image.shape == (64, 96, 3)
        assert rng.random() == random.random()


def test_the_twelve_transforms_are_listed_under_their_jax_names():
    """``SEGMENTATION_TRANSFORMS`` holds the twelve ``Seg*`` transforms the JAX package
    registers, under the same names."""
    jax_names = {k for k, v in JAX_TRANSFORMS.items() if getattr(v, "__module__", "") == jseg.__name__}
    assert set(pseg.SEGMENTATION_TRANSFORMS) == jax_names and len(jax_names) == 12
    for name, cls in pseg.SEGMENTATION_TRANSFORMS.items():
        assert cls is getattr(pseg, name)
