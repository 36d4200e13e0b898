"""The segmentation losses and metrics of the PyTorch port against the JAX package's.

The same logits (numpy, seeded; NCHW for the port, NHWC for JAX) and ``[B, H, W]`` int
targets go through both. Losses and their aux values are held at ``rtol=1e-5`` (the
libraries' reductions sum in other orders) with ``atol`` four float32 ulps of 1.0
(``ATOL``): a dice loss is ``1 - dice``, which on confident logits cancels to ~1e-3 and
keeps the absolute rounding of the dice near 1.0, ``detail_target`` bit-equal, the gradient of
``STDCLoss`` with respect to every output map at ``rtol=1e-5`` (``atol`` 1e-9 for
gradients that are 0 in one library and ~1e-12 in the other). The confusion matrices are
equal (int64 against JAX's float32, all cells below 2**24) and ``compute`` within 1e-7.
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
from super_gradients_tpu_torch.training.metrics import get_metric
from super_gradients_tpu_torch.training.metrics import segmentation as metrics

torch.set_num_threads(2)


def _nhwc(x):
    return jnp.asarray(np.moveaxis(np.asarray(x), 1, -1))


def _targets(rng, b, h, w, c, ignore_frac=0.2, ignore_index=255):
    t = rng.randint(0, c, (b, h, w)).astype(np.int32)
    t[rng.rand(b, h, w) < ignore_frac] = ignore_index
    return t


def _logits(rng, b, c, h, w, scale=2.0):
    return (rng.randn(b, c, h, w) * scale).astype(np.float32)


def _confident(targets, c, rng, margin=8.0):
    """Logits that put ``margin`` on each pixel's target class: every CE is far below
    OHEM's threshold, so its pivot falls under it."""
    b, h, w = targets.shape
    logits = rng.randn(b, c, h, w).astype(np.float32) * 0.1
    safe = np.where(targets == 255, 0, targets)
    np.put_along_axis(logits, safe[:, None], margin, axis=1)
    return logits


ATOL = 4 * float(np.finfo(np.float32).eps)


def _value(x):
    return float(np.asarray(x))


LOSS_CASES = {  # name: (port loss, JAX loss)
    "SegCrossEntropyLoss": (losses.SegCrossEntropyLoss(), jax_losses.SegCrossEntropyLoss()),
    "OhemCELoss": (losses.OhemCELoss(), jax_losses.OhemCELoss()),
    "OhemCELoss_mining_0.3": (losses.OhemCELoss(0.6, 0.3), jax_losses.OhemCELoss(0.6, 0.3)),
    "DiceLoss": (losses.DiceLoss(), jax_losses.DiceLoss()),
    "DiceCEEdgeLoss": (losses.DiceCEEdgeLoss(aux_weights=(0.4, 0.2)), jax_losses.DiceCEEdgeLoss(aux_weights=(0.4, 0.2))),
    "STDCLoss": (losses.STDCLoss(weights=(1.0, 0.7, 0.5), detail_weights=(1.0, 0.5)),
                 jax_losses.STDCLoss(weights=(1.0, 0.7, 0.5), detail_weights=(1.0, 0.5))),
}


def _outputs(name, rng, b, c, h, w, targets, confident=False):
    """The loss's outputs: a map, or the tuples that STDC and DiceCEEdgeLoss train on."""
    main = _confident(targets, c, rng) if confident else _logits(rng, b, c, h, w)
    if name == "STDCLoss":
        return (main, _logits(rng, b, c, h, w), _logits(rng, b, c, h, w), _logits(rng, b, 1, h, w))
    if name == "DiceCEEdgeLoss":
        return (main, _logits(rng, b, c, h, w), _logits(rng, b, c, h, w), _logits(rng, b, c, h, w))
    return main


@pytest.mark.parametrize("confident", [False, True], ids=["random", "confident"])
@pytest.mark.parametrize("ignore", ["some", "none", "all"])
@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_and_aux_match_jax(name, ignore, confident):
    """Each loss and its aux dict at rtol 1e-5, with void pixels, none, or only void ones
    (0, not NaN); random logits put OHEM's pivot above its threshold, confident ones below."""
    rng = np.random.RandomState(len(name) + 7 * confident)
    b, c, h, w = 2, 5, 24, 20
    targets = _targets(rng, b, h, w, c, ignore_frac={"some": 0.2, "none": 0.0, "all": 1.0}[ignore])
    outputs = _outputs(name, rng, b, c, h, w, targets, confident)
    port, ref = LOSS_CASES[name]
    as_tuple = isinstance(outputs, tuple)
    got, got_aux = port(tuple(map(torch.from_numpy, outputs)) if as_tuple else torch.from_numpy(outputs),
                        torch.from_numpy(targets))
    want, want_aux = ref(tuple(map(_nhwc, outputs)) if as_tuple else _nhwc(outputs), jnp.asarray(targets))
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), _value(want), rtol=1e-5, atol=ATOL)
    assert set(got_aux) == set(want_aux)
    for k in got_aux:
        np.testing.assert_allclose(float(got_aux[k]), _value(want_aux[k]), rtol=1e-5, atol=ATOL, err_msg=k)
    if ignore == "all" and name in ("SegCrossEntropyLoss", "OhemCELoss"):
        assert got.item() == 0.0


def _ohem_pivot_above(logits, targets, loss):
    """Whether OHEM's ``num_mining``-th largest CE exceeds its threshold (the branch taken)."""
    ce = losses.pixel_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets)).reshape(-1)
    valid = int((targets != 255).sum())
    num_mining = min(int(np.float32(loss.mining_percent) * np.float32(valid)), valid - 1)
    return bool(torch.sort(ce, descending=True).values[num_mining] > loss.thresh)


def test_ohem_cases_reach_both_branches():
    rng = np.random.RandomState(len("OhemCELoss"))
    targets = _targets(rng, 2, 24, 20, 5)
    assert _ohem_pivot_above(_logits(rng, 2, 5, 24, 20), targets, losses.OhemCELoss())
    rng = np.random.RandomState(len("OhemCELoss") + 7)
    targets = _targets(rng, 2, 24, 20, 5)
    assert not _ohem_pivot_above(_confident(targets, 5, rng), targets, losses.OhemCELoss())


def test_ohem_mining_count_is_float32():
    """OHEM over a ramp of losses with a threshold that no pixel passes, so the loss is the
    mean of the top ``num_mining = int32(float32(0.1) * float32(n_valid))`` pixels: equal
    to JAX's at several pixel counts."""
    loss = losses.OhemCELoss(threshold=0.999, mining_percent=0.1)
    for n in (30, 70, 1000):
        logits = np.zeros((1, 3, 1, n), np.float32)
        logits[0, 0, 0] = np.linspace(-4.0, 4.0, n)
        targets = np.zeros((1, 1, n), np.int32)
        got, _ = loss(torch.from_numpy(logits), torch.from_numpy(targets))
        want, _ = jax_losses.OhemCELoss(0.999, 0.1)(_nhwc(logits), jnp.asarray(targets))
        np.testing.assert_allclose(got.item(), _value(want), rtol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64), (97, 131)])
def test_detail_target_bit_equal(hw):
    """The Laplacian boundary target at an even size and at an odd one, where the stride-2
    and stride-4 maps resize back by a non-integer factor."""
    rng = np.random.RandomState(hw[0])
    targets = _targets(rng, 2, *hw, 6, ignore_frac=0.1)
    targets = np.repeat(np.repeat(targets[:, ::4, ::4], 4, axis=1), 4, axis=2)[:, : hw[0], : hw[1]]
    got = losses.detail_target(torch.from_numpy(np.ascontiguousarray(targets))).numpy()
    want = np.asarray(jax_losses.detail_target(jnp.asarray(targets)))
    assert got.shape == want.shape == (2, *hw) and 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got, want)


def test_stdc_loss_gradient_matches_jax():
    """d STDCLoss / d (main, aux32, aux16, detail8), at rtol 1e-5."""
    rng = np.random.RandomState(11)
    b, c, h, w = 2, 4, 32, 40
    targets = _targets(rng, b, h, w, c)
    outputs = _outputs("STDCLoss", rng, b, c, h, w, targets)
    port = losses.STDCLoss()
    tensors = [torch.from_numpy(o).requires_grad_(True) for o in outputs]
    port(tuple(tensors), torch.from_numpy(targets))[0].backward()
    ref = jax.grad(lambda outs: jax_losses.STDCLoss()(outs, jnp.asarray(targets))[0])(tuple(map(_nhwc, outputs)))
    for t, r in zip(tensors, ref):
        g = t.grad.permute(0, 2, 3, 1).numpy()
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-5, atol=1e-9)


def test_losses_run_in_fp32_on_bf16_logits():
    rng = np.random.RandomState(12)
    targets = torch.from_numpy(_targets(rng, 2, 16, 16, 3))
    logits = torch.from_numpy(_logits(rng, 2, 3, 16, 16))
    for loss in (losses.SegCrossEntropyLoss(), losses.OhemCELoss(), losses.DiceCEEdgeLoss()):
        value, _ = loss(logits.bfloat16(), targets)
        ref, _ = loss(logits.bfloat16().float(), targets)
        assert value.dtype == torch.float32 and value.item() == ref.item()


def test_bce_dice_and_binary_dice_match_jax():
    rng = np.random.RandomState(13)
    logits = _logits(rng, 2, 1, 12, 10)
    targets = (rng.rand(2, 12, 10) > 0.5).astype(np.int32)
    got, got_aux = losses.BCEDiceLoss((0.3, 0.7))(torch.from_numpy(logits), torch.from_numpy(targets))
    want, want_aux = jax_losses.BCEDiceLoss((0.3, 0.7))(_nhwc(logits), jnp.asarray(targets))
    np.testing.assert_allclose(got.item(), _value(want), rtol=1e-5)
    for k in ("bce", "dice"):
        np.testing.assert_allclose(float(got_aux[k]), _value(want_aux[k]), rtol=1e-5)
    got, _ = losses.BinaryDiceLoss()(torch.from_numpy(logits), torch.from_numpy(targets.astype(np.float32)))
    want, _ = jax_losses.BinaryDiceLoss()(_nhwc(logits), jnp.asarray(targets, jnp.float32))
    np.testing.assert_allclose(got.item(), _value(want), rtol=1e-5)


def test_dice_ce_edge_loss_has_no_edge_term():
    """As in JAX: ``num_aux_heads``, ``ce_edge_weights`` and ``weights`` change nothing."""
    rng = np.random.RandomState(14)
    targets = torch.from_numpy(_targets(rng, 2, 16, 16, 3))
    outputs = tuple(torch.from_numpy(_logits(rng, 2, 3, 16, 16)) for _ in range(2))
    base, _ = losses.DiceCEEdgeLoss()(outputs, targets)
    other, _ = losses.DiceCEEdgeLoss(num_aux_heads=3, ce_edge_weights=(0.9, 0.1), weights=(5.0,))(outputs, targets)
    assert base.item() == other.item()


def test_losses_registered_under_the_jax_names():
    from super_gradients_tpu.common.registry import LOSSES as JAX_LOSSES

    names = ("SegCrossEntropyLoss", "OhemCELoss", "DiceLoss", "BinaryDiceLoss", "STDCLoss", "DiceCEEdgeLoss",
             "BCEDiceLoss")
    for name in names:
        assert name in JAX_LOSSES
        assert type(get_loss(name, {})).__name__ == JAX_LOSSES[name].__name__
    assert isinstance(get_loss("STDCLoss", {"num_classes": 19, "ignore_index": 255}), losses.STDCLoss)


# ------------------------------------------------------------------ metrics


METRIC_CASES = {  # name: (port metric, JAX metric, output channels)
    "IoU": (lambda: metrics.IoU(6), lambda: jax_metrics.IoU(6), 6),
    "Dice": (lambda: metrics.Dice(6), lambda: jax_metrics.Dice(6), 6),
    "PixelAccuracy": (lambda: metrics.PixelAccuracy(6), lambda: jax_metrics.PixelAccuracy(6), 6),
    "BinaryIoU": (lambda: metrics.BinaryIoU(), lambda: jax_metrics.BinaryIoU(), 1),
    "BinaryDice": (lambda: metrics.BinaryDice(), lambda: jax_metrics.BinaryDice(), 1),
    "BinaryIoU_two_channels": (lambda: metrics.BinaryIoU(), lambda: jax_metrics.BinaryIoU(), 2),
}


def _metric_batches(rng, channels, n=3):
    num_classes = max(channels, 2)
    batches = []
    for i in range(n):
        targets = rng.randint(0, num_classes, (2, 20, 24)).astype(np.int32)
        targets[rng.rand(*targets.shape) < 0.15] = 255
        targets[0, :2] = num_classes + 3  # targets >= C are not counted
        if num_classes > 2:
            targets[targets == num_classes - 1] = 0  # the last class is absent from the targets
        batches.append((_logits(rng, 2, channels, 20, 24), targets))
    return batches


@pytest.mark.parametrize("name", list(METRIC_CASES))
def test_metric_matches_jax(name):
    """The confusion matrix equal to JAX's and ``compute`` within 1e-7, over three
    batches with void pixels, targets >= C and a class absent from the targets."""
    make_port, make_jax, channels = METRIC_CASES[name]
    port, ref = make_port(), make_jax()
    state, jstate = port.init(), ref.init()
    for logits, targets in _metric_batches(np.random.RandomState(len(name)), channels):
        state = port.update(state, torch.from_numpy(logits), torch.from_numpy(targets))
        jstate = ref.update(jstate, _nhwc(logits), jnp.asarray(targets))
    assert state.dtype == torch.int64
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate).astype(np.int64))
    got, want = port.compute(state), ref.compute(jstate)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7)
        assert 0.0 < got[k] < 1.0


def test_metric_tuple_outputs_and_empty_state():
    """Train-mode tuples are read by their main map; a metric that saw no batch computes 0."""
    rng = np.random.RandomState(15)
    logits, targets = _metric_batches(rng, 4, n=1)[0]
    m = metrics.IoU(4)
    a = m.update(m.init(), torch.from_numpy(logits), torch.from_numpy(targets))
    b = m.update(m.init(), (torch.from_numpy(logits), torch.zeros(1)), torch.from_numpy(targets))
    assert torch.equal(a, b)
    assert m.compute(m.init()) == {"IoU": 0.0} and metrics.PixelAccuracy(4).compute(None) == {"PixelAccuracy": 0.0}


def test_confusion_matrix_counts_exactly_past_float32():
    """int64 cells count past 2**24, where JAX's float32 matmul stops counting by ones."""
    preds = torch.zeros(2**24 + 3, dtype=torch.int64)
    targets = torch.zeros(2**24 + 3, dtype=torch.int32)
    cm = metrics.confusion_matrix(preds, targets, 2, 255)
    assert cm[0, 0].item() == 2**24 + 3
    assert np.float32(2**24) + np.float32(1) == np.float32(2**24)  # what a float32 cell would do


def test_metrics_registered_under_the_jax_names():
    for name in ("IoU", "Dice", "PixelAccuracy", "BinaryIoU", "BinaryIOU", "BinaryDice"):
        assert isinstance(get_metric(name), metrics._ConfusionMatrixMetric)
    m = get_metric({"IoU": {"num_classes": 19, "ignore_index": 255}})
    assert (m.num_classes, m.ignore_index, m.name) == (19, 255, "IoU")
