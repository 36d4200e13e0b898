"""Export of the PyTorch port (``conversion/export.py``) against the JAX package's exported programs.

Each case exports the same weights in both packages (the port's ``torch.export`` ``.pt2``,
JAX's ``jax.export`` artifact), loads both back and runs them on the same seeded uint8 images:

- detection, ``yolo_nas_s`` with 8 classes at 64x64 (every ``cls_pred`` bias at 0, so that
  random weights detect), batch 2, ``nms_top_k = 64``, ``max_predictions = 10``, in the
  ``exact`` and ``fast`` NMS modes and in fp32 and bf16. fp32: ``num_detections`` and labels
  equal, boxes within ``atol = 5e-2`` px and scores within ``5e-4`` (the fp32 predict
  tolerances of ``tests/test_torch_predict.py``); bf16 as the JAX package holds its own export
  (``tests/test_deployment.py``): ``num_detections`` equal, boxes within ``rtol = 1e-2,
  atol = 1.0``. The loaded artifact is also bit-equal to the port's live
  ``predict_batch_tensor`` on the same images divided by 255;
- pose, ``yolo_nas_pose_s`` at 64x64 in fp32: the fp32 pose predict tolerances of
  ``tests/test_torch_pose_predict.py``;
- segmentation, ``stdc1_seg`` at 64x64 with 5 classes (argmax) and with one class
  (``sigmoid > 0.5``), fp32: at least 99.9% of the pixels equal.

Also: ``torch.library.opcheck`` of K1's op ``sg_torch::nms_exact_keep`` (CPU implementation
and fake kernel), the op inside the exact programs and not the fast ones, ``model.export``'s
dispatch, the wrong-task ``TypeError``s, the int8 refusal, the photometric functions against
JAX's, and ``ModelConversionCheckCallback`` in a one-step detection ``Trainer.train``.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.conversion import export as jax_export
from super_gradients_tpu.inference import processing as jax_processing
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion import export
from super_gradients_tpu_torch.conversion.from_jax import YOLO_NAS_POSE_RULES, variables_from_jax_to_torch
from super_gradients_tpu_torch.inference import processing
from super_gradients_tpu_torch.ops.kernels import nms_exact
from super_gradients_tpu_torch.training import RandomDetectionDataset, Trainer
from super_gradients_tpu_torch.training.callbacks import ModelConversionCheckCallback
from test_torch_pose_model import jax_pose_numpy_variables
from test_torch_segmentation_model import carried_pair as seg_carried_pair
from test_torch_yolo_nas import jax_numpy_variables
from torch_jax_init import jax_model

torch.set_num_threads(2)

HW, BATCH = 64, 2
DET = dict(batch_size=BATCH, image_hw=(HW, HW), nms_top_k=64, max_predictions=10)


def _images(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (BATCH, HW, HW, 3), dtype=np.uint8)


def _round_trip(tmp_path, jax_model_, port_model, exporter, name, **kw):
    """(JAX artifact's outputs, the port artifact's outputs, the port's ExportResult, the loaded port
    program) on :func:`_images`."""
    jax_path, port_path = str(tmp_path / f"{name}.jax"), str(tmp_path / f"{name}.pt2")
    getattr(jax_export, exporter)(jax_model_, jax_path, **kw)
    result = getattr(export, exporter)(port_model, port_path, **kw)
    images = _images()
    ref = jax_export.load_exported(jax_path).call(jnp.asarray(images))
    program = export.load_exported(port_path)
    return ref, program.call(images), result, program


@pytest.fixture(scope="module")
def detection_pair():
    jm = jax_model("yolo_nas_s", num_classes=8, image_size=HW)
    v = jax_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    pm = models.get("yolo_nas_s", num_classes=8, image_size=HW, device="cpu")
    pm.net.load_state_dict(variables_from_jax_to_torch(v), strict=True)
    return jm, pm


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_detection_export_matches_jax_and_the_live_predict(detection_pair, tmp_path, mode, bf16):
    jm, pm = detection_pair
    ref, got, result, program = _round_trip(tmp_path, jm, pm, "export_detection_model", "det", nms_mode=mode,
                                            bf16=bf16, **DET)
    assert isinstance(got, export.NMSOutput) and got.boxes.shape == (BATCH, 10, 4)
    # exact NMS stays in the program as K1's op (its CPU implementation here: the plain version)
    ops = {str(n.target) for n in program.program.graph.nodes if n.op == "call_function"}
    assert ("sg_torch.nms_exact_keep.default" in ops) == (mode == "exact")
    assert result.input_shape == (BATCH, HW, HW, 3) and result.input_dtype == "uint8"
    assert "uint8 [2, 64, 64, 3]" in result.usage_instructions and "load_exported" in repr(result)
    ref_boxes, ref_scores, ref_labels, ref_num = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(got.num_detections.numpy(), ref_num)
    assert ref_num.min() > 0
    if bf16:
        np.testing.assert_allclose(got.boxes.numpy(), ref_boxes, rtol=1e-2, atol=1.0)
    else:
        np.testing.assert_array_equal(got.labels.numpy(), ref_labels)
        np.testing.assert_allclose(got.boxes.numpy(), ref_boxes, atol=5e-2, rtol=0)
        np.testing.assert_allclose(got.scores.numpy(), ref_scores, atol=5e-4, rtol=0)
    live = pm.predict_batch_tensor(torch.from_numpy(_images()).float() / 255.0, nms_mode=mode, bf16=bf16,
                                   nms_top_k=64, max_predictions=10)
    assert all(torch.equal(a, b) for a, b in zip(got, live))


def test_k1_op_passes_opcheck_and_equals_its_plain_version():
    """``sg_torch::nms_exact_keep`` passes ``torch.library.opcheck`` (CPU implementation and fake
    kernel) on a valid prefix and on scattered valid boxes, and gives the plain version's mask."""
    rng = np.random.RandomState(9)
    xy = rng.rand(2, 70, 2) * 40
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.rand(2, 70, 2) * 20 + 1], -1).astype(np.float32))
    for valid in (torch.arange(70)[None].expand(2, 70) < torch.tensor([[50], [70]]), torch.from_numpy(rng.rand(2, 70) > 0.3)):
        torch.library.opcheck(nms_exact.nms_exact_keep_op, (boxes, valid.contiguous(), 0.5))
        assert torch.equal(nms_exact.exact_nms_keep(boxes, valid.contiguous(), 0.5),
                           nms_exact.exact_nms_keep_plain(boxes, valid.contiguous(), 0.5))


def test_pose_export_matches_jax(tmp_path):
    jm = jax_model("yolo_nas_pose_s", image_size=HW)
    v = jax_pose_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    pm = models.get("yolo_nas_pose_s", image_size=HW, device="cpu")
    pm.net.load_state_dict(variables_from_jax_to_torch(v, rules=YOLO_NAS_POSE_RULES), strict=True)
    kw = dict(batch_size=BATCH, image_hw=(HW, HW), nms_top_k=64, max_predictions=10, confidence_threshold=0.2, bf16=False)
    ref, got, _, _ = _round_trip(tmp_path, jm, pm, "export_pose_estimation_model", "pose", **kw)
    assert isinstance(got, export.PoseNMSOutput) and got.poses.shape == (BATCH, 10, 17, 3)
    ref_poses, ref_boxes, ref_scores, ref_num = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(got.num_detections.numpy(), ref_num)
    assert ref_num.min() > 0
    np.testing.assert_allclose(got.scores.numpy(), ref_scores, atol=5e-4, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), ref_boxes, atol=5e-2, rtol=0)
    np.testing.assert_allclose(got.poses.numpy()[..., :2], ref_poses[..., :2], atol=5e-2, rtol=0)
    np.testing.assert_allclose(got.poses.numpy()[..., 2], ref_poses[..., 2], atol=5e-4, rtol=0)


@pytest.mark.parametrize("num_classes", [5, 1])
def test_segmentation_export_matches_jax(tmp_path, num_classes):
    jm, pm, _ = seg_carried_pair("stdc1_seg", num_classes=num_classes)
    ref, got, _, _ = _round_trip(tmp_path, jm, pm, "export_segmentation_model", "seg", batch_size=BATCH,
                                 image_hw=(HW, HW), bf16=False)
    ref = np.asarray(ref)
    assert got.dtype == torch.int32 and got.shape == ref.shape == (BATCH, HW, HW)
    assert (got.numpy() == ref).mean() >= 0.999
    assert len(np.unique(ref)) > 1


def test_export_dispatch_refusals_and_wrong_tasks(detection_pair, tmp_path):
    _, pm = detection_pair
    classifier = models.get("resnet18", num_classes=4, arch_params={"width_mult": 0.25}, device="cpu")
    with pytest.raises(NotImplementedError, match="export\\(\\) is not supported for task `classification`"):
        classifier.export(str(tmp_path / "x.pt2"))
    with pytest.raises(TypeError, match="requires a DetectionModel; got task `classification`"):
        export.export_detection_model(classifier, str(tmp_path / "x.pt2"))
    with pytest.raises(TypeError, match="requires a pose model; got task `detection`"):
        export.export_pose_estimation_model(pm, str(tmp_path / "x.pt2"))
    with pytest.raises(TypeError, match="requires a segmentation model; got task `detection`"):
        export.export_segmentation_model(pm, str(tmp_path / "x.pt2"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 8, 'Deployment and scale-out'"):
        pm.export(str(tmp_path / "x.pt2"), quantization_mode="int8", **DET)
    with pytest.raises(ValueError, match="quantization_mode must be None or 'int8'"):
        pm.export(str(tmp_path / "x.pt2"), quantization_mode="fp8", **DET)
    assert not os.path.exists(tmp_path / "x.pt2")


def test_photometric_functions_match_jax():
    """The processing's in-program steps give JAX's values and types: a bf16 batch normalized by
    float32 mean and std computes in float32 in both, the channel reversal, the composition."""
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    ops = [(processing.StandardizeImage(), jax_processing.StandardizeImage()),
           (processing.NormalizeImage(mean, std), jax_processing.NormalizeImage(mean, std)),
           (processing.ReverseImageChannels(), jax_processing.ReverseImageChannels())]
    port = processing.ComposeProcessing([p for p, _ in ops]).get_equivalent_photometric_fn()
    ref = jax_processing.ComposeProcessing([j for _, j in ops]).get_equivalent_photometric_fn()
    x = _images(3)
    got = port(torch.from_numpy(x).to(torch.bfloat16))
    want = ref(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert processing.DetectionCenterPadding((8, 8)).get_equivalent_photometric_fn() is None


def test_model_conversion_check_callback_in_a_training_step(tmp_path, caplog):
    model = models.get("yolo_nas_s", num_classes=4, image_size=HW, device="cpu")
    loader = torch.utils.data.DataLoader(RandomDetectionDataset(4, (HW, HW), 4, 8), batch_size=4)
    path = str(tmp_path / "check.pt2")
    params = dict(max_epochs=1, loss="PPYoloELoss", criterion_params={"num_classes": 4}, save_model=False,
                  phase_callbacks=[{"ModelConversionCheckCallback": {"image_size": HW, "out_path": path}}],
                  sg_logger_params={"tensorboard": False})
    with caplog.at_level(logging.INFO):
        Trainer("conversion_check", ckpt_root_dir=str(tmp_path)).train(model, params, loader)
    assert os.path.getsize(path) > 0 and "export round-trip OK" in caplog.text
    classifier = models.get("resnet18", num_classes=4, arch_params={"width_mult": 0.25}, device="cpu")
    context = type("Context", (), {"model": classifier, "experiment_name": "x"})()
    with caplog.at_level(logging.WARNING):
        ModelConversionCheckCallback(out_path=str(tmp_path / "never.pt2")).on_training_start(context)
    assert "skipping" in caplog.text and not os.path.exists(tmp_path / "never.pt2")
