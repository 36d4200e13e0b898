"""Kernel K1 (exact NMS keep mask) of the PyTorch port.

On the CPU the port's plain version must be BIT-EQUAL to both JAX forms of exact
NMS: the Pallas kernel in interpret mode (``pallas_exact_nms_keep``) and the XLA
loop (``_exact_keep_mask``). On a card the CUDA kernel must be bit-equal to the
plain version (``cuda`` marker; skips without a GPU). The JAX package is imported
inside the JAX comparisons only, so that the ``cuda`` cases run on a machine
without JAX: ``python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_nms_kernel.py``.
"""

import numpy as np
import pytest
import torch

from super_gradients_tpu_torch.ops.kernels.nms_exact import exact_nms_keep, exact_nms_keep_plain

torch.set_num_threads(2)


def _random_boxes(seed, b, k, num_classes=0):
    """Score-sorted random boxes as in tests/test_pallas_nms.py (+ optional class offset)."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(b, k, 2) * 300
    wh = rng.rand(b, k, 2) * 80 + 10
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    if num_classes:
        boxes += (rng.randint(0, num_classes, (b, k)).astype(np.float32) * 8192.0)[..., None]
    scores = -np.sort(-rng.rand(b, k).astype(np.float32), axis=1)
    return boxes, scores > 0.1


def _chain():
    """A-B overlap, B-C overlap, A-C don't: greedy keeps A and C."""
    boxes = np.zeros((1, 3, 4), np.float32)
    boxes[0, 0] = [0, 0, 10, 10]
    boxes[0, 1] = [3, 0, 13, 10]
    boxes[0, 2] = [8, 0, 18, 10]
    return boxes, np.ones((1, 3), bool)


def _threshold_pair():
    """Integer boxes whose IoU is exactly float32(0.3): inter 3, union 10."""
    boxes = np.array([[[0, 0, 3, 3], [2, 0, 3, 4]]], np.float32)
    return boxes, np.ones((1, 2), bool)


def _sparse_valid():
    """Row 0 all invalid, row 1 a single valid box among overlapping ones."""
    boxes, _ = _random_boxes(3, 2, 84)
    valid = np.zeros((2, 84), bool)
    valid[1, 5] = True
    return boxes, valid


def _tile_chain():
    """Chains of boxes 3 px apart across the tile edges at 63/64/65 and 127/128/129.

    Neighbours overlap at IoU 0.54, boxes two apart at 0.25, all others not at all;
    at t=0.3 greedy keeps every other box of a chain.
    """
    k = 130
    boxes = np.zeros((1, k, 4), np.float32)
    for i in range(k):
        boxes[0, i] = [100.0 * i, 0, 100.0 * i + 10, 10]
    for start in (60, 124):
        for n, i in enumerate(range(start, min(start + 9, k))):
            boxes[0, i] = [20000.0 * (start // 60) + 3 * n, 0, 20000.0 * (start // 60) + 3 * n + 10, 10]
    return boxes, np.ones((1, k), bool)


def _prefix(n):
    """K=1024 class-offset boxes of which the first ``n`` are valid, as the predict path's prefilter gives."""
    boxes, _ = _random_boxes(14, 1, 1024, num_classes=4)
    return boxes, np.arange(1024)[None, :] < n


def _non_prefix():
    """Scattered valid boxes, with a whole tile (64..127) invalid inside the valid extent."""
    boxes, _ = _random_boxes(15, 2, 300)
    valid = np.random.RandomState(15).rand(2, 300) < 0.4
    valid[:, 64:128] = False
    return boxes, valid


def _identical():
    return np.tile(np.array([[[5, 5, 50, 40]]], np.float32), (1, 150, 1)), np.ones((1, 150), bool)


def _disjoint():
    i = np.arange(150, dtype=np.float32)
    x, y = (i % 15) * 20, (i // 15) * 20
    return np.stack([x, y, x + 10, y + 10], -1)[None], np.ones((1, 150), bool)


FIXTURES = {
    "seed0_k256": (lambda: _random_boxes(0, 2, 256), 0.5),
    "seed1_k256": (lambda: _random_boxes(1, 2, 256), 0.5),
    "seed2_k256": (lambda: _random_boxes(2, 2, 256), 0.5),
    "chain": (_chain, 0.3),
    "k84": (lambda: _random_boxes(4, 2, 84), 0.5),
    "k200_t07": (lambda: _random_boxes(5, 3, 200), 0.7),
    "sparse_valid": (_sparse_valid, 0.5),
    "class_offset": (lambda: _random_boxes(6, 2, 200, num_classes=3), 0.5),
    # IoU == t is not suppressed; one float below t it is
    "iou_equals_t": (_threshold_pair, 0.3),
    "iou_above_t": (_threshold_pair, float(np.nextafter(np.float32(0.3), np.float32(0)))),
    # the sweep's 64-box tiles: ragged and exact edges, chains across them, valid extents
    **{f"k{k}": (lambda k=k: _random_boxes(20 + k, 2, k), 0.5) for k in (1, 63, 64, 65, 128, 129)},
    "k1000": (lambda: _random_boxes(21, 1, 1000, num_classes=4), 0.5),
    "tile_chain": (_tile_chain, 0.3),
    **{f"prefix_{n}_of_1024": (lambda n=n: _prefix(n), 0.6) for n in (0, 1, 64, 300)},
    "non_prefix": (_non_prefix, 0.5),
    "identical": (_identical, 0.5),
    "disjoint": (_disjoint, 0.5),
}


def _jax_pallas(boxes, valid, t):
    import jax.numpy as jnp

    from super_gradients_tpu.ops.pallas.nms_kernel import BLOCK, pallas_exact_nms_keep

    k = boxes.shape[1]
    pad = (-k) % BLOCK  # the caller's padding, as ops/nms.py does it
    pb = np.pad(boxes, ((0, 0), (0, pad), (0, 0)))
    pv = np.pad(valid, ((0, 0), (0, pad)))
    out = pallas_exact_nms_keep(jnp.asarray(pb), jnp.asarray(pv), iou_threshold=t, interpret=True)
    return np.asarray(out)[:, :k] > 0


def _jax_loop(boxes, valid, t):
    import jax.numpy as jnp

    from super_gradients_tpu.ops.bbox import box_iou as jax_box_iou
    from super_gradients_tpu.ops.nms import _exact_keep_mask

    return np.stack([
        np.asarray(_exact_keep_mask(jax_box_iou(jnp.asarray(bx), jnp.asarray(bx)), jnp.asarray(v), t))
        for bx, v in zip(boxes, valid)
    ])


@pytest.mark.parametrize("name", list(FIXTURES))
def test_plain_bit_equal_to_jax(name):
    make, t = FIXTURES[name]
    boxes, valid = make()
    got = exact_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), t).numpy()
    np.testing.assert_array_equal(got, _jax_loop(boxes, valid, t))
    np.testing.assert_array_equal(got, _jax_pallas(boxes, valid, t))


def test_known_keep_masks():
    boxes, valid = _chain()
    assert exact_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.3).tolist() == [[True, False, True]]
    boxes, valid = _threshold_pair()
    assert exact_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.3).tolist() == [[True, True]]
    t_below = FIXTURES["iou_above_t"][1]
    assert exact_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), t_below).tolist() == [[True, False]]
    boxes, valid = _sparse_valid()
    keep = exact_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    assert keep.sum().item() == 1 and keep[1, 5]


def test_known_keep_masks_across_tiles():
    boxes, valid = _tile_chain()
    keep = exact_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.3)[0].numpy()
    chained = set(range(60, 69)) | set(range(124, 130))
    expected = [i not in chained or (i - (60 if i < 124 else 124)) % 2 == 0 for i in range(130)]
    assert keep.tolist() == expected
    boxes, valid = _identical()
    assert exact_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)[0].nonzero().flatten().tolist() == [0]
    boxes, valid = _disjoint()
    assert exact_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5).all()
    boxes, valid = _prefix(0)
    assert not exact_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.6).any()


def test_wrapper_rejects_bad_inputs():
    boxes = torch.zeros(1, 8, 4)
    valid = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        exact_nms_keep(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError):
        exact_nms_keep(boxes, valid.int(), 0.5)
    with pytest.raises(ValueError):
        exact_nms_keep(boxes[:, ::2], valid[:, :4], 0.5)
    with pytest.raises(ValueError):
        exact_nms_keep(boxes, valid[:, :4], 0.5)


def test_plain_path_does_not_count_launches():
    before = exact_nms_keep.launches
    boxes, valid = _random_boxes(0, 1, 64)
    exact_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    assert exact_nms_keep.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FIXTURES))
def test_cuda_kernel_bit_equal_to_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU mode)")
    make, t = FIXTURES[name]
    boxes, valid = make()
    b, v = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
    before = exact_nms_keep.launches
    got = exact_nms_keep(b, v, t)
    torch.cuda.synchronize()
    assert exact_nms_keep.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), exact_nms_keep_plain(b, v, t).cpu().numpy())
