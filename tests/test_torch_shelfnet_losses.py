"""ShelfNetOHEMLoss, ShelfNetSemanticEncodingLoss and MaskAttentionLoss of the PyTorch port
against the JAX package's, values and gradients with respect to every output.

The same seeded logits (NCHW for the port, NHWC for JAX) and ``[B, H, W]`` int targets go
through both in fp64 (``jax.enable_x64``). The JAX losses cast the logits to float32 before
their softmax and sigmoid, the port keeps fp64 on fp64 logits, so the two are held at
``rtol = 1e-5`` with ``atol`` four float32 ulps of 1.0, as
``tests/test_torch_segmentation_losses_metrics.py`` holds the other segmentation losses. The
cases cover: ShelfNet-LW's three heads and one map alone; HW's ``(main, se, aux)`` with
ignored pixels (``-1``, the default) that must not count in the SE class presence; a mask of every pixel, one with a foreground, and an all-background
mask (its term 0), ``[B, H, W, 1]`` as JAX takes it, passed as ``mask=`` and packed with the
targets; and the constructors' errors.

The COCO recipe scores its 21-class ShelfNet with a 19-class ``PixelAccuracy``: the
segmentation metrics of both packages take logits with more classes than the metric's, and
drop the pixels predicted past it (JAX's one-hot of such a prediction is all zeros).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.training.losses import segmentation_losses as jax_losses
from super_gradients_tpu.training.metrics import segmentation as jax_metrics
from super_gradients_tpu_torch.training.losses import get_loss
from super_gradients_tpu_torch.training.losses import segmentation_losses as losses
from super_gradients_tpu_torch.training.metrics import segmentation as metrics

torch.set_num_threads(2)

RTOL = 1e-5
ATOL = 4 * float(np.finfo(np.float32).eps)
B, C, H, W = 2, 21, 12, 10


def _logits(rng, *shape, scale=2.0):
    return rng.randn(*shape) * scale


def _nhwc(x):
    return np.moveaxis(x, 1, -1) if x.ndim == 4 else x


def compare(port_loss, jax_loss, outputs, targets, *extra):
    """Both losses' totals, logged values and gradients with respect to every output."""
    t_out = [torch.tensor(o, requires_grad=True) for o in outputs]
    total, logs = port_loss(tuple(t_out) if len(t_out) > 1 else t_out[0], torch.from_numpy(targets),
                            *(torch.from_numpy(e) for e in extra))
    total.backward()
    with jax.enable_x64():
        def fn(outs):
            res, aux = jax_loss(tuple(outs) if len(outs) > 1 else outs[0], jnp.asarray(targets),
                                *(jnp.asarray(e) for e in extra))
            return res, aux

        (j_total, j_logs), grads = jax.value_and_grad(fn, has_aux=True)([jnp.asarray(_nhwc(o)) for o in outputs])
    total, logs = float(total.detach()), {k: float(v.detach()) for k, v in logs.items()}
    np.testing.assert_allclose(total, float(j_total), rtol=RTOL, atol=ATOL)
    assert set(logs) == set(j_logs)
    for k in logs:
        np.testing.assert_allclose(logs[k], float(j_logs[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    for got, ref in zip(t_out, grads):
        np.testing.assert_allclose(_nhwc(got.grad.numpy()), np.asarray(ref), rtol=RTOL, atol=1e-9)
    return total, logs


@pytest.mark.parametrize("heads", [3, 1])
def test_shelfnet_ohem_loss_sums_every_head(heads):
    rng = np.random.RandomState(heads)
    outputs = [_logits(rng, B, C, H, W) for _ in range(heads)]
    targets = rng.randint(0, C, (B, H, W)).astype(np.int32)
    targets[rng.rand(B, H, W) < 0.2] = 255
    port, ref = losses.ShelfNetOHEMLoss(mining_percent=0.2), jax_losses.ShelfNetOHEMLoss(mining_percent=0.2)
    total, logs = compare(port, ref, outputs, targets)
    assert set(logs) == {f"ohem_{i}" for i in range(heads)}
    assert total == pytest.approx(sum(logs.values()), rel=1e-12)
    assert type(get_loss("ShelfNetOHEMLoss", {"ignore_lb": 255})) is losses.ShelfNetOHEMLoss


def test_shelfnet_semantic_encoding_loss_with_ignored_pixels():
    rng = np.random.RandomState(5)
    outputs = [_logits(rng, B, C, H, W), _logits(rng, B, C), _logits(rng, B, C, H, W)]
    targets = rng.randint(0, 6, (B, H, W)).astype(np.int32)  # a few classes present an image
    targets[0] = np.maximum(targets[0], 1)
    targets[0, :4] = -1  # ignored: no CE, and class 0 (their clipped id) stays absent from image 0
    port = get_loss("ShelfNetSemanticEncodingLoss", {})
    assert (port.se_weight, port.nclass, port.aux_weight, port.ignore_index) == (0.2, 21, 0.4, -1)
    total, logs = compare(port, jax_losses.ShelfNetSemanticEncodingLoss(), outputs, targets)
    assert total == pytest.approx(logs["ce_main"] + 0.4 * logs["ce_aux"] + 0.2 * logs["se_bce"], rel=1e-12)


@pytest.mark.parametrize("mask_kind", ["foreground", "all_background", "all"])
@pytest.mark.parametrize("packed", [False, True])
def test_mask_attention_loss(mask_kind, packed):
    rng = np.random.RandomState(7)
    logits = _logits(rng, B, C, H, W)
    targets = rng.randint(0, C, (B, H, W)).astype(np.int32)
    targets[rng.rand(B, H, W) < 0.1] = 255
    mask = {"foreground": (rng.rand(B, H, W, 1) < 0.3), "all_background": np.zeros((B, H, W, 1)),
            "all": np.ones((B, H, W, 1))}[mask_kind].astype(np.float64)
    port, ref = losses.MaskAttentionLoss(loss_weights=(1.0, 0.5)), jax_losses.MaskAttentionLoss(loss_weights=(1.0, 0.5))
    if packed:
        pair_port = lambda o, t, m: port(o, (t, m))  # noqa: E731
        pair_jax = lambda o, t, m: ref(o, (t, m))  # noqa: E731
        _, logs = compare(pair_port, pair_jax, [logits], targets, mask)
    else:
        _, logs = compare(port, ref, [logits], targets, mask)
    if mask_kind == "all_background":
        assert logs["loss_mask"] == 0.0
    if mask_kind == "all":
        assert logs["loss_mask"] == pytest.approx(logs["loss_base"], rel=1e-12)


def test_mask_attention_loss_constructor_errors():
    for package in (losses, jax_losses):
        with pytest.raises(ValueError, match="loss_weights must have 2 values, found 3"):
            package.MaskAttentionLoss(loss_weights=(1.0, 1.0, 1.0))
        with pytest.raises(ValueError, match="mask loss weight must be positive"):
            package.MaskAttentionLoss(loss_weights=(1.0, 0.0))


@pytest.mark.parametrize("name", ["PixelAccuracy", "IoU", "Dice"])
def test_metric_of_fewer_classes_than_the_model_matches_jax(name):
    """A 21-class prediction scored by a 19-class metric over two batches: predictions 19 and
    20, targets past the metric and ``ignore_index`` pixels are dropped as in JAX."""
    rng = np.random.RandomState(5)
    port, ref = getattr(metrics, name)(num_classes=19, ignore_index=255), getattr(jax_metrics, name)(num_classes=19,
                                                                                                     ignore_index=255)
    state, j_state = port.init(), ref.init()
    for _ in range(2):
        logits = rng.randn(B, C, H, W).astype(np.float32)
        logits[:, 19:] += 1.5  # a third of the pixels predicted past the metric's classes
        targets = rng.randint(0, 19, (B, H, W))
        targets[rng.rand(B, H, W) < 0.2] = 255
        targets[rng.rand(B, H, W) < 0.05] = 20
        state = port.update(state, torch.from_numpy(logits), torch.from_numpy(targets))
        j_state = ref.update(j_state, jnp.asarray(_nhwc(logits)), jnp.asarray(targets))
    np.testing.assert_array_equal(port._matrix(state), np.asarray(j_state))
    assert 0 < np.asarray(j_state).sum() < 2 * B * H * W
    got, want = port.compute(state), ref.compute(j_state)
    assert got.keys() == want.keys()
    for k in got:  # JAX divides its float32 matrix, the port a float64 copy of its counts
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
