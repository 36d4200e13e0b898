"""The predict slice of the PyTorch port against the JAX package's, end to end.

``get("yolo_nas_s", num_classes=4, image_size=64, device="cpu")`` carries the JAX
model's weights (``cls_pred`` biases at 0, so that random weights detect
something). ``predict()`` runs on odd-sized uint8 images through letterbox,
forward, decode and exact NMS.

The letterbox is the JAX package's ``cv2.resize`` wherever cv2 imports, so both
pipelines see byte-equal pixels (pinned below), and the fp32 detections must agree
in count and labels, with boxes to ``atol=5e-2`` and scores to ``atol=5e-4``.
Without cv2 the port resizes with ``F.interpolate``, one grey level from cv2 on ~12%
of the pixels (also pinned). bf16 rounds at other places in the two libraries; it is
held to matched detection sets at a stated looser bound.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from super_gradients_tpu import models as jax_models
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.inference.processing import resize_bilinear
from super_gradients_tpu_torch.ops.bbox import box_iou
from super_gradients_tpu_torch.ops.kernels.nms_exact import exact_nms_keep
from test_torch_yolo_nas import jax_numpy_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((50, 70), (64, 64), (97, 33))


@pytest.fixture(scope="module")
def pair():
    jm = jax_models.get("yolo_nas_s", num_classes=4, image_size=64)
    v = jax_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    pm = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu")
    pm.net.load_state_dict(variables_from_jax_to_torch(v), strict=True)
    return jm, pm


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SIZES]


def matched_fraction(a, b, iou_min):
    """Share of detections matched one to one across two sets: same label and
    IoU >= iou_min (or identical boxes, which clipping can make zero-area)."""
    if len(a) == 0 or len(b) == 0:
        return float(len(a) == len(b))
    iou = box_iou(torch.from_numpy(a.bboxes_xyxy), torch.from_numpy(b.bboxes_xyxy)).numpy()
    same = np.abs(a.bboxes_xyxy[:, None] - b.bboxes_xyxy[None]).max(-1) <= 1e-3
    ok = ((iou >= iou_min) | same) & (a.labels[:, None] == b.labels[None])
    used, matched = set(), 0
    for i in range(len(a)):
        for j in np.flatnonzero(ok[i]):
            if j not in used:
                used.add(j)
                matched += 1
                break
    return matched / max(len(a), len(b))


def test_resize_within_one_grey_level_of_cv2():
    """F.interpolate bilinear (half-pixel, no antialias) vs cv2 INTER_LINEAR:
    at most one grey level apart (cv2 uses 11-bit fixed-point weights)."""
    import cv2

    rng = np.random.RandomState(1)
    for (h, w), (oh, ow) in [((50, 70), (43, 60)), ((97, 33), (60, 20)), ((480, 640), (477, 636)), ((20, 30), (61, 92))]:
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        got = resize_bilinear(img, (oh, ow)).astype(int)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR).astype(int)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1


@pytest.mark.parametrize("image_size", [64, 640])
def test_letterbox_byte_equal_to_jax(image_size):
    """Where cv2 imports, the predict letterbox (longest-side rescale, centre padding, /255)
    is the JAX package's, byte for byte; without it the rescale is ``resize_bilinear``."""
    import super_gradients_tpu.inference.processing as jax_processing
    from super_gradients_tpu_torch.inference import processing

    rng = np.random.RandomState(7)
    port, ref = (m.default_yolo_nas_coco_processing(image_size) for m in (processing, jax_processing))
    for h, w in SIZES + ((480, 640), (720, 1280), (image_size - 4, image_size - 4)):
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        got, metas = port.preprocess_image(img)
        want, jmetas = ref.preprocess_image(img)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        boxes = rng.uniform(0, image_size, (5, 4)).astype(np.float32)
        np.testing.assert_array_equal(port.postprocess_boxes(boxes.copy(), metas),
                                      ref.postprocess_boxes(boxes.copy(), jmetas))
    img = rng.randint(0, 256, (50, 70, 3), dtype=np.uint8)
    assert processing.cv2_module() is not None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(processing, "cv2_module", lambda: None)
        np.testing.assert_array_equal(processing.resize(img, (43, 60)), resize_bilinear(img, (43, 60)))


@pytest.mark.parametrize("fuse_model", [True, False])
def test_predict_fp32_matches_jax(pair, fuse_model):
    jm, pm = pair
    images = _images()
    ref = jm.predict(images, bf16=False, fuse_model=fuse_model)
    got = pm.predict(images, bf16=False, fuse_model=fuse_model)
    assert len(got) == len(ref) == len(SIZES)
    for g, r in zip(got, ref):
        assert len(g) > 0 and len(g) == len(r)
        np.testing.assert_array_equal(g.labels, r.labels)
        np.testing.assert_allclose(g.bboxes_xyxy, r.bboxes_xyxy, atol=5e-2, rtol=0)
        np.testing.assert_allclose(g.confidence, r.confidence, atol=5e-4, rtol=0)
        assert g.image.shape == r.image.shape


def test_predict_bf16_matches_jax_loosely(pair):
    """bf16 convs round differently in the two libraries (and the JAX init's logits
    reach |100|, so 0.4% bf16 steps move scores a lot): at least 70% of the
    detections must match one to one with the same label at IoU >= 0.5."""
    jm, pm = pair
    images = _images(1)
    ref = jm.predict(images)
    got = pm.predict(images)
    for g, r in zip(got, ref):
        assert len(g) > 0 and np.isfinite(g.bboxes_xyxy).all() and np.isfinite(g.confidence).all()
        assert matched_fraction(g, r, 0.5) >= 0.7


def test_predict_batch_tensor_matches_jax(pair):
    jm, pm = pair
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    ref = jm.predict_batch_tensor(jnp.asarray(x), bf16=False)
    got = pm.predict_batch_tensor(torch.from_numpy(x), bf16=False)
    np.testing.assert_array_equal(got.num_detections.numpy(), np.asarray(ref.num_detections))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=5e-2, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=5e-4, rtol=0)
    assert (got.num_detections > 0).all()


def test_predict_nms_modes(pair, monkeypatch):
    """exact and pallas both run kernel K1 (its plain version on the CPU) and agree."""
    import super_gradients_tpu_torch.ops.nms as nms_mod

    _, pm = pair
    calls = []

    def counting(boxes, valid, t):
        calls.append(boxes.shape)
        return exact_nms_keep(boxes, valid, t)

    monkeypatch.setattr(nms_mod, "exact_nms_keep", counting)
    images = _images(3)
    exact, pallas = (pm.predict(images, bf16=False, nms_mode=m) for m in ("exact", "pallas"))
    assert len(calls) == 2
    for e, p in zip(exact, pallas):
        np.testing.assert_array_equal(e.labels, p.labels)
        np.testing.assert_array_equal(e.bboxes_xyxy, p.bboxes_xyxy)
    for mode in ("fast", "matrix"):
        assert all(len(p) > 0 for p in pm.predict(images, bf16=False, nms_mode=mode))


def _zero_cls_bias(model):
    for name, module in model.net.named_modules():
        if name.endswith("cls_pred"):
            module.bias.data.zero_()
    return model


@pytest.mark.parametrize("deploy", [dict(), dict(fuse_model=False, bf16=False)])
def test_load_state_dict_drops_stale_deploy_nets(deploy):
    """New weights loaded through ``DetectionModel.load_state_dict`` reach predict(),
    also after predict() has built (and cached) its deploy-form network."""
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32))
    model = _zero_cls_bias(models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu", seed=0))
    other = _zero_cls_bias(models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu", seed=1))
    before = model.predict_batch_tensor(x, **deploy)
    model.load_state_dict(other.net.state_dict())
    got, ref = model.predict_batch_tensor(x, **deploy), other.predict_batch_tensor(x, **deploy)
    assert not torch.equal(before.boxes, ref.boxes)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    with pytest.raises(RuntimeError):
        model.load_state_dict({"not_a_key": torch.zeros(1)})


def test_get_on_cuda_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        models.get("yolo_nas_s", num_classes=4, image_size=64)


def test_unported_inputs_and_outputs_raise(pair, tmp_path):
    """Inputs that are no image raise as in the JAX package; pretrained weights raise
    naming their ROADMAP item; a checkpoint loads."""
    jm, pm = pair
    for bad, error in ((12345, TypeError), (str(tmp_path / "missing.jpg"), FileNotFoundError)):
        with pytest.raises(error):
            jm.predict(bad)
        with pytest.raises(error):
            pm.predict(bad)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        models.get("yolo_nas_s", device="cpu", pretrained_weights="coco")
    # checkpoint_path loads a .pth of the original super-gradients layout, ema_net first
    live = {k: v + 1 if v.is_floating_point() else v for k, v in pm.net.state_dict().items()}
    path = str(tmp_path / "ckpt.pth")
    torch.save({"net": live, "ema_net": pm.net.state_dict(), "epoch": 0}, path)
    loaded = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu", seed=5, checkpoint_path=path)
    x = torch.from_numpy(np.random.RandomState(6).rand(1, 64, 64, 3).astype(np.float32))
    for g, r in zip(loaded.predict_batch_tensor(x, bf16=False), pm.predict_batch_tensor(x, bf16=False)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    torch.save({"net": live}, path)
    loaded = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu", checkpoint_path=path)
    assert all(torch.equal(v, live[k]) for k, v in loaded.net.state_dict().items())


def test_port_runs_with_jax_blocked(tmp_path):
    """The port imports and predicts with jax, flax, cv2, PIL, yaml and the JAX package
    unavailable, and never imports them: every module of the recipe, data and predict
    surface imports, predict takes the no-cv2 letterbox, reading an image or a YAML recipe
    raises an ImportError that names PIL or PyYAML, and, once PIL is back, a COCO-format
    dataset of PNGs runs one sample through the YOLO-NAS train chain (cv2 still blocked:
    the numpy / torch stand-ins)."""
    rng = np.random.RandomState(1)
    os.makedirs(tmp_path / "images")
    for i in range(4):
        Image.fromarray(rng.randint(0, 256, (48 + 8 * i, 64, 3), dtype=np.uint8)).save(tmp_path / "images" / f"{i}.png")
    Image.fromarray(rng.randint(0, 256, (8, 8, 3), dtype=np.uint8)).save(tmp_path / "x.jpg")
    coco = {"images": [{"id": i, "file_name": f"{i}.png"} for i in range(4)],
            "annotations": [{"id": i, "image_id": i, "category_id": 1, "bbox": [4, 4, 20, 16], "iscrowd": 0}
                            for i in range(4)],
            "categories": [{"id": 1, "name": "a"}]}
    (tmp_path / "coco.json").write_text(json.dumps(coco))
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "flax", "cv2", "PIL", "yaml", "super_gradients_tpu"):
            sys.modules[name] = None
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from super_gradients_tpu_torch import evaluate_checkpoint, evaluate_from_recipe, models, resume_experiment
        from super_gradients_tpu_torch import train_from_recipe
        from super_gradients_tpu_torch.common import config
        from super_gradients_tpu_torch.training import Trainer, dataloaders, datasets, datasets_roboflow
        from super_gradients_tpu_torch.training import callbacks, pre_launch_callbacks, samplers
        from super_gradients_tpu_torch.inference import media, prediction_results, processing, stream, video
        assert processing.cv2_module() is None
        model = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu")
        for name, module in model.net.named_modules():
            if name.endswith("cls_pred"):
                module.bias.data.zero_()
        rng = np.random.RandomState(0)
        preds = model.predict([rng.randint(0, 256, (64, 64, 3), dtype=np.uint8)])
        assert len(preds) == 1 and len(preds[0]) > 0, len(preds[0])
        assert np.isfinite(preds[0].bboxes_xyxy).all()
        try:
            datasets.load_image({str(tmp_path / "x.jpg")!r})
        except ImportError as e:
            assert "PIL" in str(e)
        else:
            raise AssertionError("an image read without PIL")
        try:
            config.load_recipe("roboflow_yolo_nas_m")
        except ImportError as e:
            assert "PyYAML" in str(e)
        else:
            raise AssertionError("a YAML recipe read without PyYAML")
        del sys.modules["PIL"]
        ds = datasets.COCOFormatDetectionDataset({str(tmp_path)!r}, "coco.json", "images",
                                                 transforms=dataloaders._yolo_nas_train_transforms((64, 64)))
        image, target = ds[0]
        assert image.dtype == np.uint8 and image.shape == (3, 64, 64) and ds.max_value == 255.0
        print("OK", len(preds[0]))
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
