"""The port's predict inputs and outputs against the JAX package's, on the CPU: image
inputs (arrays, PIL images, files, folders), video files (as ``tests/test_video_io.py``
holds the JAX ones, the bogus capture device included), drawing and saving predictions
(byte-equal to the JAX package's PIL drawing), and ``predict()`` on a folder, a PIL
image, a file and a video against the JAX ``predict()`` on the same weights (fp32:
labels equal, boxes to ``atol=5e-2``, scores to ``atol=5e-4``, as
``tests/test_torch_predict.py`` holds arrays)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from super_gradients_tpu.inference import media as jax_media
from super_gradients_tpu.inference import prediction_results as jax_results
from super_gradients_tpu.inference import stream as jax_stream
from super_gradients_tpu.inference import video as jax_video
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.inference import media, prediction_results, stream, video
from test_torch_yolo_nas import jax_numpy_variables
from torch_jax_init import jax_model

torch.set_num_threads(2)


def _frames(n=8, h=48, w=64):
    rng = np.random.RandomState(0)
    return [rng.randint(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def pair():
    jm = jax_model("yolo_nas_s", num_classes=4, image_size=64)
    v = jax_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    pm = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu")
    pm.net.load_state_dict(variables_from_jax_to_torch(v), strict=True)
    return jm, pm


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """PNG and JPEG files of mixed modes and sizes, an upper-case extension and a text file."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(1)
    Image.fromarray(rng.randint(0, 256, (50, 70, 3), dtype=np.uint8)).save(root / "b.png")
    Image.fromarray(rng.randint(0, 256, (64, 64, 3), dtype=np.uint8)).save(root / "a.jpg", quality=90)
    Image.fromarray(rng.randint(0, 256, (40, 33), dtype=np.uint8), mode="L").save(root / "c.PNG")
    Image.fromarray(rng.randint(0, 256, (30, 45, 4), dtype=np.uint8), mode="RGBA").save(root / "d.webp")
    (root / "notes.txt").write_text("not an image")
    return str(root)


def _inputs(folder):
    rng = np.random.RandomState(2)
    return [rng.randint(0, 256, (20, 30, 3), dtype=np.uint8), rng.randint(0, 256, (20, 30), dtype=np.uint8),
            rng.uniform(-20, 300, (10, 12, 3)), rng.randint(0, 256, (2, 8, 9, 3), dtype=np.uint8),
            Image.fromarray(rng.randint(0, 256, (9, 7), dtype=np.uint8), mode="L"),
            Image.fromarray(rng.randint(0, 256, (9, 7, 4), dtype=np.uint8), mode="RGBA"),
            os.path.join(folder, "a.jpg"), folder, [os.path.join(folder, "b.png"), np.zeros((4, 5, 3), np.uint8)]]


def test_image_inputs_equal_jax(folder):
    for source in _inputs(folder):
        got, ref = media.images_to_list(source), jax_media.images_to_list(source)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype == np.uint8 and g.shape == r.shape and g.shape[-1] == 3
            np.testing.assert_array_equal(g, r)
    assert len(media.images_to_list(folder)) == 4  # sorted, by extension, any case
    for bad in (12345, None, {"a": 1}):
        with pytest.raises(TypeError):
            media.load_image(bad)


def test_extension_helpers():
    for module in (video, jax_video):
        assert module.includes_video_extension("a.mp4") and module.includes_video_extension("A.GIF")
        assert not module.includes_video_extension("a.jpg") and not module.includes_video_extension(123)
        assert module.check_is_gif("x.gif") and not module.check_is_gif("x.mp4")


def test_mp4_roundtrip_reads_as_jax(tmp_path):
    path = str(tmp_path / "clip.mp4")
    frames = _frames()
    video.save_video(path, frames, fps=10)
    loaded, fps = video.load_video(path)
    ref, ref_fps = jax_video.load_video(path)
    assert fps == ref_fps == 10 and len(loaded) == len(ref) == len(frames)
    for g, r in zip(loaded, ref):
        np.testing.assert_array_equal(g, r)
    corr = np.corrcoef(loaded[0].astype(np.float32).ravel(), frames[0].astype(np.float32).ravel())[0, 1]
    assert corr > 0.5  # mp4 is lossy
    jpath = str(tmp_path / "jax.mp4")
    jax_video.save_video(jpath, frames, fps=10)
    for g, r in zip(video.load_video(jpath)[0], loaded):
        np.testing.assert_array_equal(g, r)  # the same encoder on the same frames


def test_lazy_load_respects_max_frames(tmp_path):
    path = str(tmp_path / "clip.avi")
    video.save_video(path, _frames(10), fps=5)
    it, fps, total = video.lazy_load_video(path, max_frames=3)
    assert (fps, total) == (5, 3) and len(list(it)) == 3
    assert jax_video.lazy_load_video(path, max_frames=3)[1:] == (fps, total)


def test_gif_roundtrip(tmp_path):
    path, jpath = str(tmp_path / "clip.gif"), str(tmp_path / "jax.gif")
    video.save_gif(path, _frames(4), fps=5)
    jax_video.save_gif(jpath, _frames(4), fps=5)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    assert len(video.load_video(path)[0]) >= 3  # gif readers may merge duplicate frames


def test_video_errors(tmp_path):
    with pytest.raises(ValueError, match="output_path"):
        video.save_video(str(tmp_path / "clip.txt"), _frames(2), fps=5)
    with pytest.raises(RuntimeError, match="frame size"):
        video.save_video(str(tmp_path / "c.mp4"), [_frames(1)[0], np.zeros((32, 32, 3), np.uint8)], fps=5)
    for save in (video.save_gif, video.save_mp4):
        with pytest.raises(ValueError, match="no frames"):
            save(str(tmp_path / "empty.gif"), [], fps=5)
    with pytest.raises(ValueError, match="cannot open video"):
        video.load_video(str(tmp_path / "missing.mp4"))


def test_fps_counter_and_stream_headless():
    c = stream.FPSCounter()
    for _ in range(3):
        fps = c.tick()
    assert fps > 0 and c.fps == fps
    ws = stream.WebcamStreaming(frame_processing_fn=lambda f: f, capture=999)
    with pytest.raises(ValueError, match="capture device"):
        ws.run()  # a bogus device id fails loudly, without a display
    frame = np.zeros((40, 120, 3), np.uint8)
    np.testing.assert_array_equal(stream.write_fps_to_frame(frame.copy(), 12.5),
                                  jax_stream.write_fps_to_frame(frame.copy(), 12.5))


def _detections(seed, n=5, h=48, w=64):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-5, [w - 4, h - 4], (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 30, (n, 2))], 1).astype(np.float32)
    return dict(bboxes_xyxy=boxes, confidence=rng.rand(n).astype(np.float32), labels=rng.randint(0, 25, n),
                image=rng.randint(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("kwargs", [dict(), dict(box_thickness=3, show_confidence=False)])
@pytest.mark.parametrize("class_names", [None, [f"class_{i}" for i in range(25)]])
def test_draw_and_save_byte_equal_to_jax(tmp_path, kwargs, class_names):
    for seed in range(3):
        d = _detections(seed)
        got = prediction_results.DetectionPrediction(**d, class_names=class_names)
        ref = jax_results.DetectionPrediction(**d, class_names=class_names)
        drawn = got.draw(**kwargs)
        assert drawn.dtype == np.uint8 and drawn.shape == d["image"].shape and not np.array_equal(drawn, d["image"])
        np.testing.assert_array_equal(drawn, ref.draw(**kwargs))
        np.testing.assert_array_equal(got.show(**kwargs), drawn)
        got.save(str(tmp_path / "got.png"), **kwargs)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "got.png")), drawn)
    preds = [prediction_results.DetectionPrediction(**_detections(s)) for s in range(3)]
    prediction_results.ImagesPredictions(preds).save(str(tmp_path / "port"))
    jax_results.ImagesPredictions([jax_results.DetectionPrediction(**_detections(s)) for s in range(3)]).save(
        str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == ["pred_0.jpg", "pred_1.jpg", "pred_2.jpg"]
    for name in os.listdir(tmp_path / "port"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_video_predictions_draw_and_save(tmp_path):
    frames = _frames(4)
    det = dict(bboxes_xyxy=np.asarray([[4.0, 4.0, 20.0, 20.0]]), confidence=np.asarray([0.9]), labels=np.asarray([0]),
               class_names=["thing"])
    got = prediction_results.VideoPredictions([prediction_results.DetectionPrediction(**det, image=f) for f in frames], 5)
    ref = jax_results.VideoPredictions([jax_results.DetectionPrediction(**det, image=f) for f in frames], 5)
    for g, r in zip(got.draw(), ref.draw()):
        np.testing.assert_array_equal(g, r)
    out = str(tmp_path / "annotated.mp4")
    got.save(out)
    loaded, fps = video.load_video(out)
    assert fps == 5 and len(loaded) == 4 and loaded[0].shape == frames[0].shape
    got.save(str(tmp_path / "annotated.gif"))
    ref.save(str(tmp_path / "jax.gif"))
    assert (tmp_path / "annotated.gif").read_bytes() == (tmp_path / "jax.gif").read_bytes()


def _assert_same_detections(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert len(g) > 0 and len(g) == len(r)
        np.testing.assert_array_equal(g.image, r.image)
        np.testing.assert_array_equal(g.labels, r.labels)
        np.testing.assert_allclose(g.bboxes_xyxy, r.bboxes_xyxy, atol=5e-2, rtol=0)
        np.testing.assert_allclose(g.confidence, r.confidence, atol=5e-4, rtol=0)


def test_predict_on_files_folders_and_pil_images_equals_jax(pair, folder):
    jm, pm = pair
    for source in (folder, os.path.join(folder, "b.png"), Image.open(os.path.join(folder, "a.jpg")),
                   [os.path.join(folder, "c.PNG"), Image.open(os.path.join(folder, "d.webp"))]):
        _assert_same_detections(pm.predict(source, bf16=False), jm.predict(source, bf16=False))


def test_predict_on_a_video_equals_jax(pair, tmp_path):
    jm, pm = pair
    path = str(tmp_path / "clip.mp4")
    rng = np.random.RandomState(3)
    video.save_video(path, [rng.randint(0, 256, (40, 56, 3), dtype=np.uint8) for _ in range(5)], fps=7)
    got = pm.predict(path, bf16=False, batch_size=2)
    ref = jm.predict(path, bf16=False, batch_size=2)
    assert isinstance(got, prediction_results.VideoPredictions) and got.fps == ref.fps == 7
    _assert_same_detections(got, ref)
    got.save(str(tmp_path / "out.mp4"))
    frames, fps = video.load_video(str(tmp_path / "out.mp4"))
    assert fps == 7 and len(frames) == 5 and frames[0].shape == (40, 56, 3)
    assert len(pm.predict_video(path, max_frames=3, bf16=False)) == 3


def test_predict_webcam_on_a_bogus_device_raises(pair):
    _, pm = pair
    with pytest.raises(ValueError, match="capture device"):
        pm.predict_webcam(capture=999)
