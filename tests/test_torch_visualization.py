"""The port's detection visualization callbacks against the JAX package's, on the CPU.

YOLO-NAS-S, 4 classes, 64x64, the JAX model's weights carried across. The JAX
callbacks suppress with NMS ``mode="fast"``; the port's run exact NMS (kernel K1 on a
GPU), so here the JAX callbacks are given exact NMS too (ROADMAP.md section 3). Each
callback's detections must agree with the JAX callback's (labels and counts equal,
boxes to 1e-2 px and scores to 5e-4, the two libraries' fp32 forwards, as
``tests/test_torch_trainer_validation.py`` holds them), on byte-equal images, under the
same tags; each image the port sends to the logger is the JAX package's drawing of the
port's detections, byte for byte. In a real ``Trainer.train`` run the callback's images
reach the logger's PNG files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.inference import prediction_results as jax_results
from super_gradients_tpu.ops import nms as jax_nms
from super_gradients_tpu.training import callbacks as jax_callbacks
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer, callbacks
from test_torch_yolo_nas import jax_numpy_variables

torch.set_num_threads(2)

NUM_CLASSES, IMAGE = 4, 64
BOX_ATOL = 1e-2
JaxDetectionPrediction = jax_results.DetectionPrediction  # the JAX drawing, before ``recorded`` wraps it


@pytest.fixture(scope="module")
def pair():
    jm = jax_models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE)
    v = jax_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    pm = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE, device="cpu")
    pm.net.load_state_dict(variables_from_jax_to_torch(v), strict=True)
    return jm, pm


@pytest.fixture
def recorded(monkeypatch):
    """Both libraries' DetectionPrediction as drawn, in order; the JAX callbacks on exact NMS."""
    drawn = {"jax": [], "port": []}

    def recorder(base, key):
        class Recorded(base):
            def draw(self, **kwargs):
                drawn[key].append(self)
                return super().draw(**kwargs)

        return Recorded

    monkeypatch.setattr(jax_results, "DetectionPrediction", recorder(jax_results.DetectionPrediction, "jax"))
    monkeypatch.setattr(callbacks, "DetectionPrediction", recorder(callbacks.DetectionPrediction, "port"))
    exact = jax_nms.batched_nms
    monkeypatch.setattr(jax_nms, "batched_nms", lambda *a, **k: exact(*a, **{**k, "mode": "exact"}))
    return drawn


class _Logger:
    def __init__(self):
        self.images = []

    def add_image(self, tag, image, global_step=0):
        self.images.append((tag, np.asarray(image).copy(), global_step))


class _Loader:
    max_value = 255.0


def _batches(seed, n=3, b=5):
    """uint8 NCHW batches for the port, the JAX dataset's standardized NHWC floats for JAX."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        u8 = rng.randint(0, 256, (b, 3, IMAGE, IMAGE), dtype=np.uint8)
        out.append((torch.from_numpy(u8), np.multiply(u8.transpose(0, 2, 3, 1), np.float32(1 / 255), dtype=np.float32)))
    return out


def _compare(recorded, port_log, jax_log):
    assert [t for t, _, _ in port_log.images] == [t for t, _, _ in jax_log.images]
    assert [s for _, _, s in port_log.images] == [s for _, _, s in jax_log.images]
    assert len(recorded["port"]) == len(recorded["jax"]) == len(port_log.images) > 0
    detected = 0
    for (_, image, _), got, ref in zip(port_log.images, recorded["port"], recorded["jax"]):
        np.testing.assert_array_equal(got.image, ref.image)
        assert len(got) == len(ref)
        detected += len(got)
        np.testing.assert_array_equal(got.labels, ref.labels)
        np.testing.assert_allclose(got.bboxes_xyxy, ref.bboxes_xyxy, atol=BOX_ATOL, rtol=0)
        np.testing.assert_allclose(got.confidence, ref.confidence, atol=5e-4, rtol=0)
        jax_drawing = JaxDetectionPrediction(
            bboxes_xyxy=got.bboxes_xyxy, confidence=got.confidence, labels=got.labels, class_names=got.class_names,
            image=got.image).draw()
        np.testing.assert_array_equal(image, jax_drawing)
    assert detected > 0


@pytest.mark.parametrize("conf,max_images", [(0.25, 4), (0.5, 8)])
def test_detection_visualization_callback_matches_jax(pair, recorded, conf, max_images):
    jm, pm = pair
    port_log, jax_log = _Logger(), _Logger()
    port_cb = callbacks.DetectionVisualizationCallback(freq=2, batch_idx=1, max_images=max_images, conf=conf)
    jax_cb = jax_callbacks.DetectionVisualizationCallback(freq=2, batch_idx=1, max_images=max_images, conf=conf)
    port_ctx = callbacks.PhaseContext(model=pm, eval_net=pm.net, valid_loader=_Loader(), sg_logger=port_log)
    jax_ctx = jax_callbacks.PhaseContext(model=jm, sg_logger=jax_log)
    for epoch in range(3):
        for idx, (u8, floats) in enumerate(_batches(epoch)):
            port_ctx.update_context(epoch=epoch, batch_idx=idx, valid_batch=(u8, None))
            jax_ctx.update_context(epoch=epoch, batch_idx=idx, valid_batch=(floats, None))
            port_cb.on_validation_batch_end(port_ctx)
            jax_cb.on_validation_batch_end(jax_ctx)
    assert len(port_log.images) == 2 * min(5, max_images)  # epochs 0 and 2, batch 1
    _compare(recorded, port_log, jax_log)


@pytest.mark.parametrize("max_", [True, False])
def test_extreme_batch_visualization_matches_jax(pair, recorded, max_):
    """The train batch of the largest (smallest) loss of the epoch, drawn at its end."""
    jm, pm = pair
    port_log, jax_log = _Logger(), _Logger()
    port_cb = callbacks.ExtremeBatchDetectionVisualizationCallback(max_=max_, max_images=3)
    jax_cb = jax_callbacks.ExtremeBatchDetectionVisualizationCallback(max_=max_, max_images=3)
    port_ctx = callbacks.PhaseContext(model=pm, eval_net=pm.net, train_loader=_Loader(), sg_logger=port_log)
    jax_ctx = jax_callbacks.PhaseContext(model=jm, sg_logger=jax_log)
    for epoch in range(2):
        port_cb.on_train_loader_start(port_ctx)
        jax_cb.on_train_loader_start(jax_ctx)
        for (u8, floats), loss in zip(_batches(10 + epoch), (2.5, 7.25, 0.5)):
            port_ctx.update_context(epoch=epoch, train_batch=(u8, None), step_metrics={"loss": torch.tensor(loss)})
            jax_ctx.update_context(epoch=epoch, train_batch=(floats, None), step_metrics={"loss": jnp.asarray(loss)})
            port_cb.on_train_batch_end(port_ctx)
            jax_cb.on_train_batch_end(jax_ctx)
        port_cb.on_train_loader_end(port_ctx)
        jax_cb.on_train_loader_end(jax_ctx)
    assert len(port_log.images) == 6 and ("7.250" if max_ else "0.500") in port_log.images[0][0]
    _compare(recorded, port_log, jax_log)


def test_callbacks_resolve_by_name():
    for name in ("DetectionVisualizationCallback", "ExtremeBatchDetectionVisualizationCallback"):
        assert type(callbacks.resolve_callback({name: {}})).__name__ == name


def test_visualization_in_training_writes_images_through_the_logger(tmp_path):
    """``Trainer.train`` with the callback: the trained network's drawn predictions on
    the first validation batch reach ``add_image`` (PNG files beside the checkpoints)."""
    model = models.get("yolo_nas_s", num_classes=NUM_CLASSES, image_size=IMAGE, device="cpu", seed=3)
    for name, module in model.net.named_modules():
        if name.endswith("cls_pred"):
            module.bias.data.zero_()
    mk = lambda n: torch.utils.data.DataLoader(RandomDetectionDataset(n, (IMAGE, IMAGE), NUM_CLASSES, 8), batch_size=4)  # noqa: E731
    trainer = Trainer("visualize", ckpt_root_dir=str(tmp_path))
    params = dict(max_epochs=1, loss="PPYoloELoss", criterion_params={"num_classes": NUM_CLASSES}, initial_lr=1e-4,
                  optimizer="AdamW", valid_metrics_list=[{"DetectionMetrics": {"num_cls": NUM_CLASSES}}],
                  metric_to_watch="mAP@0.50:0.95", save_model=False, sg_logger_params={"tensorboard": False},
                  phase_callbacks=[{"DetectionVisualizationCallback": {"max_images": 2, "conf": 0.3}}])
    trainer.train(model, params, mk(4), mk(8))
    files = sorted(os.listdir(os.path.join(trainer.ckpt_dir, "images")))
    assert files == ["valid_detections_img0_step0.png", "valid_detections_img1_step0.png"]
    from PIL import Image

    image = np.asarray(Image.open(os.path.join(trainer.ckpt_dir, "images", files[0])))
    assert image.shape == (IMAGE, IMAGE, 3) and image.dtype == np.uint8
