"""Sliding-window tiled detection of the PyTorch port against the JAX package's.

The wrapper tiles one image on a fixed grid, runs every tile in one batch, shifts the
boxes back and merges them with one exact ``batched_nms`` over all tiles' anchors,
suppressing on ``pred_scores``. Held here on the CPU (the plain NMS): the tile grid
exactly; ``predict_image_tensor`` in fp32 (``bf16=False``) for YOLO-NAS-S and PP-YOLOE-S
at the test widths, detections equal in count and labels, boxes to 5e-2 px and scores to
5e-4 (the models' parity tolerances); ``predict`` (its /255 without a letterbox) with the
fp32 forward in both packages at the same tolerances. The JAX
``SlidingWindowValidationCallback`` calls the wrapper, which defines no ``__call__``: it
raises ``TypeError`` on a detection model with a validation loader, and so does the port's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.inference import sliding_window as jsw
from super_gradients_tpu.training import callbacks as jcb
from super_gradients_tpu_torch.inference import sliding_window as psw
from super_gradients_tpu_torch.training import callbacks as pcb
from test_torch_ppyoloe_model import pair as ppyoloe_pair  # noqa: F401  (module fixture)
from test_torch_yolo_nas import pair as yolo_nas_pair  # noqa: F401  (module fixture)

torch.set_num_threads(2)


@pytest.mark.parametrize("image_hw,tile,step", [((1080, 1920), 640, 512), ((100, 150), 64, 48), ((64, 64), 64, 48),
                                                ((30, 200), 64, 32), ((640, 641), 640, 512)])
def test_tile_origins_match_jax(image_hw, tile, step):
    got = psw.compute_tile_origins(image_hw, (tile, tile), (step, step))
    assert got == jsw.compute_tile_origins(image_hw, (tile, tile), (step, step))
    if image_hw == (1080, 1920):
        assert len(got) == 8  # the 8 tiles of a 1080p image at 640 / 512


@pytest.fixture(params=["yolo_nas_s", "ppyoloe_s"])
def models_pair(request):
    pair = request.getfixturevalue("yolo_nas_pair" if request.param == "yolo_nas_s" else "ppyoloe_pair")
    return pair[0], pair[-1]


def _image(seed=0, hw=(100, 150)):
    return np.random.RandomState(seed).rand(*hw, 3).astype(np.float32)


def assert_nms_equal(got, ref):
    np.testing.assert_array_equal(got.num_detections.numpy(), np.asarray(ref.num_detections))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=5e-2, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=5e-4, rtol=0)
    assert int(got.num_detections[0]) > 0


def test_predict_image_tensor_matches_jax(models_pair):
    jm, pm = models_pair
    jw = jsw.SlidingWindowInferenceDetectionWrapper(jm, tile_size=64, tile_step=48, tile_nms_conf=0.1)
    pw = psw.SlidingWindowInferenceDetectionWrapper(pm, tile_size=64, tile_step=48, tile_nms_conf=0.1)
    x = _image()
    ref = jw.predict_image_tensor(jnp.asarray(x), bf16=False)
    got = pw.predict_image_tensor(torch.from_numpy(x), bf16=False)
    assert_nms_equal(got, ref)
    # the merged boxes lie in image pixels, beyond the first tile
    assert float(got.boxes[0, : int(got.num_detections[0]), 2].max()) > 64


def test_predict_image_tensor_suppresses_on_scores(models_pair, monkeypatch):
    """One ``batched_nms`` over all 6 tiles' anchors, on ``pred_scores`` (not logits)."""
    _, pm = models_pair
    seen = []
    original = psw.batched_nms
    monkeypatch.setattr(psw, "batched_nms", lambda *a, **k: seen.append((a, k)) or original(*a, **k))
    pw = psw.SlidingWindowInferenceDetectionWrapper(pm, tile_size=64, tile_step=48)
    pw.predict_image_tensor(torch.from_numpy(_image(1)), bf16=False)
    (args, kwargs), = seen
    assert args[0].shape == (1, 6 * 84, 4) and args[1].shape == (1, 6 * 84, 4)
    assert "scores_are_logits" not in kwargs and kwargs["nms_top_k"] == 1024 and kwargs["mode"] == "exact"
    assert float(args[1].min()) >= 0.0 and float(args[1].max()) <= 1.0


def test_predict_matches_jax(models_pair, monkeypatch):
    """``predict`` on uint8 images of two sizes, with the fp32 forward in both packages."""
    jm, pm = models_pair
    jw = jsw.SlidingWindowInferenceDetectionWrapper(jm, tile_size=64, tile_step=48, tile_nms_conf=0.1)
    pw = psw.SlidingWindowInferenceDetectionWrapper(pm, tile_size=64, tile_step=48, tile_nms_conf=0.1)
    monkeypatch.setattr(jw, "predict_image_tensor", functools.partial(jw.predict_image_tensor, bf16=False))
    monkeypatch.setattr(pw, "predict_image_tensor", functools.partial(pw.predict_image_tensor, bf16=False))
    rng = np.random.RandomState(2)
    images = [rng.randint(0, 256, (90, 130, 3), dtype=np.uint8), rng.randint(0, 256, (64, 100, 3), dtype=np.uint8)]
    ref, got = jw.predict(images), pw.predict(images)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0
        np.testing.assert_array_equal(g.labels, r.labels)
        np.testing.assert_allclose(g.bboxes_xyxy, r.bboxes_xyxy, atol=5e-2, rtol=0)
        np.testing.assert_allclose(g.confidence, r.confidence, atol=5e-4, rtol=0)
        assert g.class_names == r.class_names and g.image is not None


def test_predict_bf16_default_runs(models_pair):
    _, pm = models_pair
    preds = psw.SlidingWindowInferenceDetectionWrapper(pm, tile_size=64, tile_step=48, tile_nms_conf=0.1).predict(
        np.random.RandomState(3).randint(0, 256, (80, 120, 3), dtype=np.uint8))
    assert len(preds) == 1 and np.isfinite(preds[0].bboxes_xyxy).all()


def test_validation_callback_raises_the_jax_type_error(yolo_nas_pair):  # noqa: F811
    """Both callbacks resolve by name and raise the same ``TypeError`` at ``wrapper(img)``
    on a detection model with a validation loader (a JAX fault, kept: ROADMAP section 3)."""
    jm, _, pm = yolo_nas_pair
    batch = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    with pytest.raises(TypeError) as ref:
        jcb.SlidingWindowValidationCallback(tile_size=32, tile_step=32).on_validation_loader_end(
            jcb.PhaseContext(model=jm, valid_loader=[(batch, np.zeros((2, 1, 5)))]))
    callback = pcb.resolve_callback({"SlidingWindowValidationCallback": {"tile_size": 32, "tile_step": 32}})
    with pytest.raises(TypeError) as got:
        callback.on_validation_loader_end(
            pcb.PhaseContext(model=pm, valid_loader=[(torch.from_numpy(batch).permute(0, 3, 1, 2), torch.zeros(2, 1, 5))]))
    assert str(got.value) == str(ref.value) == "'SlidingWindowInferenceDetectionWrapper' object is not callable"


def test_validation_callback_skips_without_detection_or_loader(yolo_nas_pair):  # noqa: F811
    _, _, pm = yolo_nas_pair
    callback = pcb.SlidingWindowValidationCallback()
    for ctx in (pcb.PhaseContext(model=pm, valid_loader=None), pcb.PhaseContext(model=object(), valid_loader=[1])):
        callback.on_validation_loader_end(ctx)
        assert "sliding_window_detections" not in ctx.metrics_dict
