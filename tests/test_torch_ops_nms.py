"""``batched_nms`` of the PyTorch port against the JAX package's, on the same inputs.

Every mode x prefilter x multi_label x class_agnostic x scores_are_logits. The
counts and labels must be equal and the boxes and scores agree to 1e-6 (the
sigmoid and the matrix-NMS exp may differ by an ulp between the libraries).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.ops.nms import batched_nms as jax_batched_nms
from super_gradients_tpu_torch.ops.kernels.nms_exact import exact_nms_keep
from super_gradients_tpu_torch.ops.nms import batched_nms

torch.set_num_threads(2)

MODES = ["exact", "pallas", "fast", "matrix"]
# prefilter only matters with multi_label
VARIANTS = [
    (multi_label, prefilter, agnostic, logits)
    for multi_label, prefilter, agnostic, logits in itertools.product([True, False], ["two_stage", "flat"], [False, True], [False, True])
    if multi_label or prefilter == "two_stage"
]


def _inputs(seed, b=2, n=300, c=6):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2).astype(np.float32) * 160
    wh = rng.rand(b, n, 2).astype(np.float32) * 60 + 4
    boxes = np.concatenate([xy, xy + wh], -1)
    logits = (rng.randn(b, n, c) * 2).astype(np.float32)
    return boxes, logits


def _run_both(boxes, scores, **kw):
    """(port NMSOutput as numpy, jax NMSOutput as numpy) on the same inputs."""
    if scores.dtype == jnp.bfloat16:
        t_scores = torch.from_numpy(scores.astype(np.float32)).bfloat16()
    else:
        t_scores = torch.from_numpy(scores)
    got = batched_nms(torch.from_numpy(boxes), t_scores, **kw)
    ref = jax.jit(lambda b, s: jax_batched_nms(b, s, **kw))(jnp.asarray(boxes), jnp.asarray(scores))
    return [t.numpy() for t in got], [np.asarray(t) for t in ref]


def _assert_same(got, ref):
    (gb, gs, gl, gn), (rb, rs, rl, rn) = got, ref
    np.testing.assert_array_equal(gn, rn)
    np.testing.assert_array_equal(gl, rl)
    np.testing.assert_allclose(gs, rs, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gb, rb, atol=1e-6, rtol=0)
    assert gl.dtype == np.int32 and gn.dtype == np.int32


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("multi_label,prefilter,agnostic,logits", VARIANTS)
def test_batched_nms_matches_jax(mode, multi_label, prefilter, agnostic, logits):
    boxes, raw = _inputs(0)
    scores = raw if logits else (1.0 / (1.0 + np.exp(-raw))).astype(np.float32)
    kw = dict(score_threshold=0.3, iou_threshold=0.5, nms_top_k=128, max_predictions=50, multi_label=multi_label,
              class_agnostic=agnostic, mode=mode, prefilter=prefilter, scores_are_logits=logits)
    got, ref = _run_both(boxes, scores, **kw)
    _assert_same(got, ref)
    assert (got[3] > 0).all()


@pytest.mark.parametrize("mode", MODES)
def test_padding_to_max_predictions(mode):
    """nms_top_k < max_predictions: outputs padded with zeros / label -1."""
    boxes, raw = _inputs(1, n=40, c=3)
    kw = dict(score_threshold=0.2, iou_threshold=0.6, nms_top_k=32, max_predictions=64, mode=mode,
              scores_are_logits=True)
    got, ref = _run_both(boxes, raw, **kw)
    _assert_same(got, ref)
    assert got[0].shape == (2, 64, 4) and (got[2][:, 32:] == -1).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("prefilter", ["two_stage", "flat"])
def test_bf16_logit_ties_follow_lax_top_k_order(mode, prefilter):
    """bf16 logits on a coarse grid: most candidates tie exactly. Both sides must
    pick and order tied candidates lowest index first (lax.top_k's rule)."""
    boxes, _ = _inputs(2)
    rng = np.random.RandomState(3)
    logits = (rng.randint(-4, 5, size=(2, 300, 6)) * 0.5).astype(jnp.bfloat16)
    kw = dict(score_threshold=0.3, iou_threshold=0.5, nms_top_k=128, max_predictions=100, mode=mode,
              prefilter=prefilter, scores_are_logits=True)
    got, ref = _run_both(boxes, logits, **kw)
    _assert_same(got, ref)


def test_exact_modes_run_kernel_k1(monkeypatch):
    """exact and pallas both go through exact_nms_keep (the plain version on CPU)."""
    import super_gradients_tpu_torch.ops.nms as nms_mod

    calls = []

    def spy(boxes, valid, t):
        calls.append(tuple(boxes.shape))
        return exact_nms_keep(boxes, valid, t)

    monkeypatch.setattr(nms_mod, "exact_nms_keep", spy)
    boxes, raw = _inputs(4)
    for mode in ("exact", "pallas"):
        batched_nms(torch.from_numpy(boxes), torch.from_numpy(raw), mode=mode, nms_top_k=128, scores_are_logits=True)
    assert calls == [(2, 128, 4), (2, 128, 4)]


def test_unknown_mode_raises():
    boxes, raw = _inputs(0)
    with pytest.raises(ValueError, match="Unknown NMS mode"):
        batched_nms(torch.from_numpy(boxes), torch.from_numpy(raw), mode="bogus")
