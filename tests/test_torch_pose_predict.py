"""``PoseEstimationModel.predict`` of the port against the JAX package's.

YOLO-NAS-POSE-N, 64x64, the JAX weights carried across (``cls_pred`` biases at 0), on
mixed-size uint8 images through the YOLO-NAS COCO letterbox (byte-equal to JAX where cv2
imports). fp32 (``bf16=False``), unfused and fused: the same number of poses a image,
joints and boxes to ``atol=5e-2`` px and scores to ``atol=5e-4`` after
``postprocess_keypoints`` / ``postprocess_boxes``; bf16 loosely (70% of the boxes matched
one to one at IoU >= 0.5); ``predict_batch_tensor`` as fp32 predict. PIL images, image
files and drawing go through the media code of the detection predict path. A task model
takes no CPU default: without a GPU it raises unless ``device="cpu"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import YOLO_NAS_POSE_RULES, variables_from_jax_to_torch
from super_gradients_tpu_torch.inference import processing
from super_gradients_tpu_torch.models.sg_model import DetectionModel, PoseEstimationModel
from super_gradients_tpu_torch.ops.bbox import box_iou
from test_torch_pose_model import jax_pose_numpy_variables
from torch_jax_init import jax_model

torch.set_num_threads(2)
SIZES = ((50, 70), (64, 64), (97, 33))
CONF = 0.2


@pytest.fixture(scope="module")
def pair():
    jm = jax_model("yolo_nas_pose_n", image_size=64)
    v = jax_pose_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    pm = models.get("yolo_nas_pose_n", image_size=64, device="cpu")
    pm.net.load_state_dict(variables_from_jax_to_torch(v, rules=YOLO_NAS_POSE_RULES), strict=True)
    return jm, pm


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SIZES]


def _assert_close(g, r):
    assert len(g) > 0 and len(g) == len(r)
    assert g.poses.shape == (len(g), 17, 3) and g.bboxes_xyxy.shape == (len(g), 4)
    np.testing.assert_allclose(g.scores, r.scores, atol=5e-4, rtol=0)
    np.testing.assert_allclose(g.poses[..., :2], r.poses[..., :2], atol=5e-2, rtol=0)
    np.testing.assert_allclose(g.poses[..., 2], r.poses[..., 2], atol=5e-4, rtol=0)
    np.testing.assert_allclose(g.bboxes_xyxy, r.bboxes_xyxy, atol=5e-2, rtol=0)
    assert g.edge_links == r.edge_links and g.image.shape == r.image.shape


@pytest.mark.parametrize("fuse_model", [False, True])
def test_predict_fp32_matches_jax(pair, fuse_model):
    jm, pm = pair
    images = _images()
    ref = jm.predict(images, conf=CONF, bf16=False)
    got = pm.predict(images, conf=CONF, bf16=False, fuse_model=fuse_model)
    assert len(got) == len(ref) == len(SIZES)
    for g, r in zip(got, ref):
        _assert_close(g, r)


def _matched_fraction(a, b, iou_min=0.5):
    iou = box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    used, matched = set(), 0
    for i in range(len(a)):
        for j in np.flatnonzero(iou[i] >= iou_min):
            if j not in used:
                used.add(j)
                matched += 1
                break
    return matched / max(len(a), len(b), 1)


def test_predict_bf16_matches_jax_loosely(pair):
    """The JAX package casts every variable to bf16, the port keeps BatchNorm in fp32 (its
    bf16 deploy form); the decode and sigmoids run in fp32 in both."""
    jm, pm = pair
    images = _images(1)
    ref = jm.predict(images, conf=CONF)
    got = pm.predict(images, conf=CONF)
    for g, r in zip(got, ref):
        assert len(g) > 0 and np.isfinite(g.poses).all() and np.isfinite(g.scores).all()
        assert _matched_fraction(g.bboxes_xyxy, r.bboxes_xyxy) >= 0.7


def test_predict_batch_tensor_matches_jax(pair):
    jm, pm = pair
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    ref = jm.predict_batch_tensor(jnp.asarray(x), conf=CONF, bf16=False)
    got = pm.predict_batch_tensor(torch.from_numpy(x), conf=CONF, bf16=False)
    np.testing.assert_array_equal(got.num_detections.numpy(), np.asarray(ref.num_detections))
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=5e-2, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=5e-2, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=5e-4, rtol=0)
    assert (got.num_detections > 0).all() and got.poses.shape == (2, 30, 17, 3)


def test_predict_defaults_are_the_jax_ones(pair):
    _, pm = pair
    assert (pm._default_nms_conf, pm._default_nms_iou) == (0.5, 0.7)
    assert (pm._default_pre_nms_max_predictions, pm._default_post_nms_max_predictions) == (1024, 30)
    preds = pm.predict(_images(3)[:1], conf=0.01, max_predictions=5, pre_nms_max_predictions=50)
    assert 0 < len(preds[0]) <= 5


def test_keypoints_postprocess_byte_equal_to_jax():
    """``postprocess_keypoints`` of the letterbox (rescale, centre padding) and of the pose
    processing parameters (BGR, bottom-right padding with 127) as in JAX."""
    import super_gradients_tpu.inference.processing as jax_processing

    rng = np.random.RandomState(4)
    ref_params = jax_processing.default_yolo_nas_pose_coco_processing_params()
    got_params = processing.default_yolo_nas_pose_coco_processing_params()
    assert {k: v for k, v in got_params.items() if k != "image_processor"} == \
        {k: v for k, v in ref_params.items() if k != "image_processor"}
    pairs = [(processing.default_yolo_nas_coco_processing(64), jax_processing.default_yolo_nas_coco_processing(64)),
             (got_params["image_processor"], ref_params["image_processor"])]
    for port, ref in pairs:
        for h, w in SIZES + ((480, 640),):
            img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
            got, metas = port.preprocess_image(img)
            want, jmetas = ref.preprocess_image(img)
            np.testing.assert_array_equal(got, want)
            kpts = rng.uniform(0, 640, (3, 17, 3)).astype(np.float32)
            np.testing.assert_array_equal(port.postprocess_keypoints(kpts.copy(), metas),
                                          ref.postprocess_keypoints(kpts.copy(), jmetas))


def test_pil_file_inputs_and_drawing(pair, tmp_path):
    _, pm = pair
    img = _images(5)[0]
    Image.fromarray(img).save(tmp_path / "a.png")
    by_array = pm.predict(img, conf=CONF, bf16=False)
    for source in (Image.fromarray(img), str(tmp_path / "a.png"), str(tmp_path)):
        other = pm.predict(source, conf=CONF, bf16=False)
        assert len(other) == 1
        np.testing.assert_array_equal(other[0].poses, by_array[0].poses)
    drawn = by_array[0].draw()
    assert drawn.shape == img.shape and drawn.dtype == np.uint8 and not np.array_equal(drawn, img)
    by_array.save(str(tmp_path / "out"))
    assert Image.open(tmp_path / "out" / "pred_0.jpg").size == (img.shape[1], img.shape[0])


def test_task_models_take_no_cpu_default():
    """Constructing a task model without a device, or ``models.get`` of a pose model, on a
    machine without a GPU raises; ``device="cpu"`` runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    net = torch.nn.Conv2d(3, 3, 1)
    for cls in (DetectionModel, PoseEstimationModel):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(name="x", net=net)
        assert cls(name="x", net=net, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        models.get("yolo_nas_pose_s", image_size=64)
    assert type(models.get("yolo_nas_pose_n", image_size=64, device="cpu")) is PoseEstimationModel


def test_predict_video_draws_poses(pair, tmp_path):
    """``predict()`` on a video file gives one pose result a frame, and its ``save()``
    writes the drawn video at the source frame rate."""
    from super_gradients_tpu_torch.inference import video
    from super_gradients_tpu_torch.inference.prediction_results import VideoPredictions

    _, pm = pair
    frames = [np.random.RandomState(i).randint(0, 256, (48, 64, 3), dtype=np.uint8) for i in range(3)]
    path = str(tmp_path / "clip.mp4")
    video.save_video(path, frames, fps=5)
    preds = pm.predict(path, conf=CONF, batch_size=2)
    assert isinstance(preds, VideoPredictions) and len(preds) == 3 and preds.fps == 5
    assert all(p.poses.shape[1:] == (17, 3) for p in preds)
    preds.save(str(tmp_path / "drawn.mp4"))
    drawn, fps = video.load_video(str(tmp_path / "drawn.mp4"))
    assert len(drawn) == 3 and drawn[0].shape == (48, 64, 3) and fps == 5


@pytest.mark.parametrize("colors", [False, True])
def test_pose_drawing_byte_equal_to_jax(colors):
    """The same poses drawn by both packages' ``PoseEstimationPrediction`` (PIL lines and
    ellipses; palette colours, or the COCO skeleton's link and joint colours)."""
    import super_gradients_tpu.inference.prediction_results as jax_results
    from super_gradients_tpu_torch.inference import prediction_results

    rng = np.random.RandomState(6)
    image = rng.randint(0, 256, (90, 120, 3), dtype=np.uint8)
    poses = np.concatenate([rng.uniform(0, 110, (4, 17, 2)), rng.uniform(-0.5, 1, (4, 17, 1))], -1).astype(np.float32)
    params = processing.default_yolo_nas_pose_coco_processing_params()
    kw = dict(poses=poses, scores=np.linspace(0.9, 0.5, 4, dtype=np.float32), bboxes_xyxy=np.zeros((4, 4), np.float32),
              edge_links=params["edge_links"], image=image)
    if colors:
        kw.update(edge_colors=params["edge_colors"], keypoint_colors=params["keypoint_colors"])
    got = prediction_results.PoseEstimationPrediction(**kw).draw()
    ref = jax_results.PoseEstimationPrediction(**kw).draw()
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, image)
