"""The port's image reading (``training/datasets.py::load_image`` / ``image_size``)
against the JAX package's ``_load_image``, on the CPU.

Tolerance: none. Both read through PIL's ``convert("RGB")``; every file (PNG in each
mode PIL writes, with and without ``optimize``, 16-bit, 1-bit and interlaced PNG, JPEG,
BMP) must give the same bytes, and ``image_size`` the file's (width, height).
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from super_gradients_tpu.training.datasets import _load_image as jax_load_image
from super_gradients_tpu_torch.training.datasets import image_size, load_image

SIZES = [(37, 53), (64, 31), (1, 17)]


def _smooth(rng, h, w, c):
    """A smooth field plus noise: PIL's filter choice then varies from line to line."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 7.0 + k) * 60 + np.cos(y / 5.0 - k) * 50 + 120 for k in range(c)], -1)
    return np.clip(base + rng.randint(-12, 13, base.shape), 0, 255).astype(np.uint8)


def _image(kind: str, rng, h: int, w: int) -> Image.Image:
    rgb = _smooth(rng, h, w, 4)
    if kind == "P":  # a 256-entry adaptive palette: 8-bit indices
        return Image.fromarray(rgb[..., :3]).convert("P", palette=Image.ADAPTIVE, colors=256)
    if kind == "I;16":
        return Image.fromarray(rgb[..., 0].astype(np.uint16) * 257)
    if kind == "1":
        return Image.fromarray(rgb[..., 0]).convert("1")
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[kind]
    return Image.fromarray(rgb[..., 0] if kind == "L" else rgb[..., :channels], kind)


def _adam7_png(image: np.ndarray) -> bytes:
    """An interlaced (Adam7) 8-bit RGB PNG, every line unfiltered: PIL writes none."""
    h, w, _ = image.shape
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = image[y0::dy, x0::dx]
        if sub.size:
            raw += np.hstack([np.zeros((sub.shape[0], 1), np.uint8), sub.reshape(sub.shape[0], -1)]).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


# (file suffix, image mode, PIL save options); mode "Adam7": an interlaced PNG written by hand
FILES = [
    ("png", "L", {}), ("png", "LA", {}), ("png", "RGB", {}), ("png", "RGBA", {}), ("png", "P", {}),
    ("png", "RGB", {"optimize": True}), ("png", "P", {"optimize": True}), ("png", "Adam7", {}),
    ("png", "I;16", {}), ("png", "1", {}), ("jpg", "RGB", {"quality": 90}), ("jpg", "L", {"quality": 90}),
    ("bmp", "RGB", {}),
]


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("suffix,kind,save", FILES, ids=[f"{s}-{k}-{'-'.join(o) or 'plain'}" for s, k, o in FILES])
def test_load_image_equals_jax(tmp_path, suffix, kind, save, hw):
    rng = np.random.RandomState(sum(map(ord, kind)) + hw[0])
    path = str(tmp_path / f"image.{suffix}")
    if kind == "Adam7":
        pixels = _smooth(rng, *hw, 3)
        with open(path, "wb") as f:
            f.write(_adam7_png(pixels))
    else:
        _image(kind, rng, *hw).save(path, **save)
    got = load_image(path)
    assert got.dtype == np.uint8 and got.shape == (*hw, 3)
    if kind == "Adam7":
        np.testing.assert_array_equal(got, pixels)
    np.testing.assert_array_equal(got, jax_load_image(path))
    assert image_size(path) == (hw[1], hw[0])
