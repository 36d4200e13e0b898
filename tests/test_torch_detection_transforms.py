"""The port's detection transforms against the JAX package's, on the CPU.

The JAX transforms draw from the global ``random``; the port's from the
``random.Random`` passed in. Both are seeded alike, so every random decision is the
same: boxes, labels and crowd flags must be exactly equal, per transform and through
the whole YOLO-NAS train chain, on both of the port's paths. The JAX package runs its
cv2 path (cv2 is installed here).

Where cv2 imports, the port makes the JAX package's cv2 calls: every image is
byte-equal, per transform and through the whole chain (``test_cv2_path_*``).

Without cv2 (forced here by the ``no_cv2`` fixture, which makes the port's cv2 getter
return None) the port runs its own image code. Image tolerances of that path, measured
on these inputs (smooth seeded fields with filled rectangles) and held here:

- flips, standardize, mixup (cv2.addWeighted's rounding half to even): equal;
- resize (padded rescale, mosaic): within 1 grey level (``F.interpolate`` vs cv2
  ``INTER_LINEAR``, as ``tests/test_torch_predict.py`` pins);
- HSV: cv2's uint8 conversions: equal where cv2 runs its vector body, within 1 grey
  level in the scalar tail of a row (which rounds where the body truncates);
- affine: >= 99.9% of pixels within 1 grey level, none off by more than 2 (cv2 warps
  in fixed point, 1/32 px and 15-bit weights);
- the whole train chain: within 1 grey level, with the JAX chain given the port's
  resize (``same_resize``). With cv2's resize the +-1 differences of the mosaic's
  resizes pass through the warp and HSV, where one grey level of a low-saturation
  pixel can move its hue: 98.0-100% of pixels within 1 grey level, at most 8 (seeds
  0-15), so the chain is held with the resize shared and the resize held alone.
"""

import random

import numpy as np
import pytest

from super_gradients_tpu.training import dataloaders as jax_loaders
from super_gradients_tpu.training.transforms import detection as jt
from super_gradients_tpu_torch.inference import processing as port_processing
from super_gradients_tpu_torch.training import dataloaders as port_loaders
from super_gradients_tpu_torch.training.transforms import detection as pt


def smooth_image(rng, h, w):
    """A smooth seeded field with filled rectangles."""
    y, x = np.mgrid[0:h, 0:w]
    phase = rng.uniform(0, 6, 6)
    img = np.stack([np.sin(x / (9.0 + k) + phase[k]) * 60 + np.cos(y / (7.0 + k) + phase[k + 3]) * 50 + 128
                    for k in range(3)], -1)
    for _ in range(3):
        y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
        img[y0:y0 + rng.randint(3, h // 2), x0:x0 + rng.randint(3, w // 2)] = rng.randint(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_samples(seed, n=4, sizes=((48, 70), (64, 64), (40, 56), (72, 50))):
    """Pairs of equal JAX and port samples: 1-8 boxes, a few crowd."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        k = rng.randint(1, 9)
        xy = rng.uniform(0, [w - 6, h - 6], (k, 2))
        wh = rng.uniform(4, [w / 2, h / 2], (k, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1).astype(np.float32)
        labels = rng.randint(0, 5, k).astype(np.int32)
        crowd = rng.rand(k) < 0.2
        image = smooth_image(rng, h, w)
        out.append((jt.DetectionSample(image.copy(), boxes.copy(), labels.copy(), crowd.copy()),
                    pt.DetectionSample(image.copy(), boxes.copy(), labels.copy(), crowd.copy())))
    return out


def run_both(jax_t, port_t, seed, samples):
    """The JAX transform under the seeded global generators, the port's with a seeded rng."""
    (js, ps), extra = samples[0], samples[1:]
    random.seed(seed)
    np.random.seed(seed)
    ref = jax_t(js, [s for s, _ in extra])
    got = port_t(ps, random.Random(seed), [s for _, s in extra])
    return ref, got


def assert_same_boxes(ref, got):
    np.testing.assert_array_equal(got.bboxes_xyxy, ref.bboxes_xyxy)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert (got.is_crowd is None) == (ref.is_crowd is None)
    if ref.is_crowd is not None:
        np.testing.assert_array_equal(got.is_crowd, ref.is_crowd)


def grey_levels(ref, got):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    return np.abs(got.astype(np.int32) - ref.astype(np.int32))


SEEDS = range(6)


@pytest.fixture
def no_cv2(monkeypatch):
    """The port's no-cv2 path: its cv2 getter returns None (the JAX package keeps cv2)."""
    monkeypatch.setattr(port_processing, "cv2_module", lambda: None)


@pytest.fixture
def same_resize(no_cv2, monkeypatch):
    """Give the JAX transforms the port's no-cv2 resize (cv2's differs by +-1 grey level)."""
    resize = port_processing.resize_bilinear
    monkeypatch.setattr(jt, "_resize", lambda image, out_hw: resize(image.astype(np.uint8), out_hw))


@pytest.mark.parametrize("name,kwargs", [("DetectionHorizontalFlip", {"prob": 0.5}),
                                         ("DetectionVerticalFlip", {"prob": 0.5}),
                                         ("DetectionStandardize", {"max_value": 255.0}),
                                         ("DetectionMixup", {"prob": 0.5})])
def test_exact_transforms(name, kwargs, no_cv2):
    for seed in SEEDS:
        ref, got = run_both(getattr(jt, name)(**kwargs), getattr(pt, name)(**kwargs), seed, make_samples(seed))
        assert_same_boxes(ref, got)
        np.testing.assert_array_equal(got.image, ref.image)


@pytest.mark.parametrize("name,kwargs", [("DetectionPaddedRescale", {"input_dim": (64, 64)}),
                                         ("DetectionPaddedRescale", {"input_dim": (96, 80)}),
                                         ("DetectionMosaic", {"input_dim": (64, 64), "prob": 0.8})])
def test_resizing_transforms_within_one_grey_level(name, kwargs, no_cv2):
    for seed in SEEDS:
        ref, got = run_both(getattr(jt, name)(**kwargs), getattr(pt, name)(**kwargs), seed, make_samples(seed))
        assert_same_boxes(ref, got)
        assert grey_levels(ref.image, got.image).max() <= 1


def test_hsv_follows_cv2(no_cv2):
    """Equal on the first 64 columns (cv2's vector body, whatever its block of 16, 32 or 64
    pixels); the last ``w % 64`` columns may be its rounding scalar tail: within 1."""
    for seed in SEEDS:
        ref, got = run_both(jt.DetectionHSV(prob=0.9), pt.DetectionHSV(prob=0.9), seed, make_samples(seed))
        assert_same_boxes(ref, got)
        diff = grey_levels(ref.image, got.image)
        body = ref.image.shape[1] // 64 * 64
        assert diff[:, :body].max() == 0 and diff.max() <= 1, seed


def test_hsv_conversions_match_cv2_on_every_colour():
    """The integer RGB->HSV equals cv2 on all 2^24 colours; HSV->RGB equals cv2's
    vector body on every (H < 180, S, V), on rows 256 wide (no scalar tail)."""
    import cv2

    for r0 in range(0, 256, 64):
        rgb = np.stack(np.meshgrid(np.arange(r0, r0 + 64), np.arange(256), np.arange(256), indexing="ij"), -1)
        rgb = rgb.astype(np.uint8).reshape(-1, 256, 3)
        np.testing.assert_array_equal(pt.rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"), -1)
    hsv = hsv.astype(np.uint8).reshape(-1, 256, 3)
    np.testing.assert_array_equal(pt.hsv_to_rgb_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_affine_follows_cv2_warp(no_cv2):
    kwargs = dict(degrees=10, translate=0.1, scales=(0.5, 1.5), shear=2.0, target_size=(64, 64))
    for seed in SEEDS:
        ref, got = run_both(jt.DetectionRandomAffine(**kwargs), pt.DetectionRandomAffine(**kwargs), seed,
                            make_samples(seed))
        assert_same_boxes(ref, got)
        diff = grey_levels(ref.image, got.image)
        assert diff.max() <= 2 and (diff <= 1).mean() >= 0.999, (seed, diff.max(), (diff <= 1).mean())


def test_mixup_of_float_images_blends_as_jax(no_cv2):
    samples = make_samples(7)
    for js, ps in samples:
        js.image = ps.image = js.image.astype(np.float32) / 3.0
    ref, got = run_both(jt.DetectionMixup(prob=1.0), pt.DetectionMixup(prob=1.0), 7, samples)
    assert_same_boxes(ref, got)
    np.testing.assert_array_equal(got.image, ref.image)


@pytest.mark.parametrize("seed", range(4))
def test_yolo_nas_train_chain_matches_jax(seed, same_resize):
    """Mosaic, affine, mixup, HSV, flip, padded rescale, standardize: boxes, labels and
    the random decisions exactly equal; the port can skip the trailing standardize."""
    chain_j = jt.ComposeDetectionTransforms(jax_loaders._yolo_nas_train_transforms((64, 64)))
    chain_p = pt.ComposeDetectionTransforms(port_loaders._yolo_nas_train_transforms((64, 64)))
    assert chain_j.additional_samples_count == chain_p.additional_samples_count == 3
    samples = make_samples(seed, n=4)
    (js, ps), extra = samples[0], samples[1:]
    random.seed(seed)
    ref = chain_j(js, [s for s, _ in extra])
    rng = random.Random(seed)
    got = chain_p(ps, rng, [s for _, s in extra], skip_trailing_standardize=True)
    assert random.random() == rng.random()  # both drew the same number of times
    assert_same_boxes(ref, got)
    assert got.image.dtype == np.uint8 and ref.image.dtype == np.float32
    host = pt.DetectionStandardize(255.0)(got, None).image
    assert np.abs(host - ref.image).max() * 255.0 <= 1.001


CV2_TRANSFORMS = [("DetectionHorizontalFlip", {"prob": 0.5}), ("DetectionVerticalFlip", {"prob": 0.5}),
                  ("DetectionStandardize", {"max_value": 255.0}), ("DetectionMixup", {"prob": 0.5}),
                  ("DetectionPaddedRescale", {"input_dim": (64, 64)}), ("DetectionPaddedRescale", {"input_dim": (96, 80)}),
                  ("DetectionMosaic", {"input_dim": (64, 64), "prob": 0.8}), ("DetectionHSV", {"prob": 0.9}),
                  ("DetectionRandomAffine", dict(degrees=10, translate=0.1, scales=(0.5, 1.5), shear=2.0,
                                                 target_size=(64, 64)))]


@pytest.mark.parametrize("name,kwargs", CV2_TRANSFORMS)
def test_cv2_path_transforms_byte_equal_to_jax(name, kwargs):
    """With cv2 the port makes the JAX package's cv2 calls: images byte-equal."""
    for seed in SEEDS:
        ref, got = run_both(getattr(jt, name)(**kwargs), getattr(pt, name)(**kwargs), seed, make_samples(seed))
        assert_same_boxes(ref, got)
        assert got.image.dtype == ref.image.dtype
        np.testing.assert_array_equal(got.image, ref.image)


def test_cv2_path_takes_no_stand_in(monkeypatch):
    """Where cv2 imports, no numpy / torch stand-in runs (each is replaced by a trap)."""

    def trap(*a, **k):
        raise AssertionError("a no-cv2 stand-in ran although cv2 imports")

    for module, name in ((port_processing, "resize_bilinear"), (pt, "warp_affine"), (pt, "rgb_to_hsv_u8"),
                         (pt, "hsv_to_rgb_u8"), (pt, "add_weighted_half")):
        monkeypatch.setattr(module, name, trap)
    chain = pt.ComposeDetectionTransforms(port_loaders._yolo_nas_train_transforms((64, 64)))
    samples = make_samples(3)
    for seed in range(4):
        chain(samples[0][1], random.Random(seed), [s for _, s in samples[1:]], skip_trailing_standardize=True)


@pytest.mark.parametrize("seed", range(4))
def test_cv2_path_yolo_nas_train_chain_byte_equal_to_jax(seed):
    """The whole YOLO-NAS train chain, cv2 on both sides and no resize shared: the port's
    uint8 image standardized on the host is byte-equal to the JAX chain's float32 image."""
    chain_j = jt.ComposeDetectionTransforms(jax_loaders._yolo_nas_train_transforms((64, 64)))
    chain_p = pt.ComposeDetectionTransforms(port_loaders._yolo_nas_train_transforms((64, 64)))
    samples = make_samples(seed, n=4)
    (js, ps), extra = samples[0], samples[1:]
    random.seed(seed)
    ref = chain_j(js, [s for s, _ in extra])
    rng = random.Random(seed)
    got = chain_p(ps, rng, [s for _, s in extra], skip_trailing_standardize=True)
    assert random.random() == rng.random()
    assert_same_boxes(ref, got)
    assert got.image.dtype == np.uint8
    np.testing.assert_array_equal(pt.DetectionStandardize(255.0)(got, None).image, ref.image)
