"""The processing-params handoff and ``pretrained_weights=`` of the PyTorch port against the
JAX package's.

- ``SgModel.set_dataset_processing_params`` / ``get_processing_params`` / ``num_params`` /
  ``replace_head`` and the Trainer's handoff from the train dataset (the port's case of
  ``tests/test_transfer_learning.py::test_trainer_sets_dataset_processing_params``).
- ``models.get(name, pretrained_weights=tag)`` from a temporary ``$SG_PRETRAINED_DIR``
  holding a ``.pth`` that the port wrote from a seeded model, under the basename of the
  published URL, against the JAX package loading the same file: the weights bit for bit,
  eval scores (logits for the classifier) within ``atol=5e-4, rtol=1e-4`` (fp32, other
  summation orders through random-init networks), equal class
  names and NMS defaults, and the two processing pipelines' outputs on one image within one
  grey level / 1e-5. With ``checkpoint_path=`` as well, the processing is attached and the
  given file is loaded, in both packages.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.inference import processing as jax_processing
from super_gradients_tpu.models import pretrained_models as jax_pretrained
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.inference import processing
from super_gradients_tpu_torch.models import pretrained_models
from super_gradients_tpu_torch.training import Trainer
from super_gradients_tpu_torch.training.dataloaders import DataLoader

torch.set_num_threads(2)

CASES = {  # name: (tag, input side of the forward check, field of the outputs compared)
    "yolo_nas_s": ("coco", 64, "pred_scores"),
    "ssd_lite_mobilenet_v2": ("coco", 320, "pred_scores"),
    "mobilenet_v3_small": ("imagenet", 64, None),
}


def test_tables_are_the_jax_tables():
    assert pretrained_models.MODEL_URLS == jax_pretrained.MODEL_URLS
    assert pretrained_models.PRETRAINED_NUM_CLASSES == jax_pretrained.PRETRAINED_NUM_CLASSES
    for name, tag in (("yolox_s", "coco"), ("ppyoloe_l", "coco"), ("yolo_nas_m", "coco"), ("resnet50", "imagenet"),
                      ("yolo_nas_pose_s", "coco_pose"), ("stdc1_seg50", "cityscapes"), ("pp_lite_b_seg75", "cityscapes"),
                      ("ssd_lite_mobilenet_v2", "coco"), ("resnet18", "cifar10")):
        got = processing.get_pretrained_processing_params(name, tag)
        ref = jax_processing.get_pretrained_processing_params(name, tag)
        assert sorted(got) == sorted(ref), (name, tag)
        for key in ("class_names", "conf", "iou", "edge_links"):
            assert got.get(key) == ref.get(key), (name, tag, key)
        if "image_processor" in ref:
            assert_same_processing(got["image_processor"], ref["image_processor"])
        assert pretrained_models.get_pretrained_url(name, tag) == jax_pretrained.get_pretrained_url(name, tag)


def assert_same_processing(got, ref):
    """The same steps, and the same output (one grey level, 1e-5 after scaling) on an image."""
    assert [type(p).__name__ for p in got.processings] == [type(p).__name__ for p in ref.processings]
    image = np.random.RandomState(0).randint(0, 256, (300, 420, 3), dtype=np.uint8)
    (g, _), (r, _) = got.preprocess_image(image), ref.preprocess_image(image)
    g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, atol=1.0 if r.max() > 2 else 1e-5)


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    """A mirror of port-written ``.pth`` files, one a case, from seed 7."""
    root = tmp_path_factory.mktemp("mirror")
    for name, (tag, _, _) in CASES.items():
        src = models.get(name, device="cpu", seed=7)
        path = root / os.path.basename(pretrained_models.get_pretrained_url(name, tag))
        torch.save({"net": src.net.state_dict()}, str(path))
    return root


@pytest.mark.parametrize("name", sorted(CASES))
def test_pretrained_weights_load_from_the_mirror_as_in_jax(name, mirror, monkeypatch):
    tag, side, field = CASES[name]
    monkeypatch.setenv("SG_PRETRAINED_DIR", str(mirror))
    pm = models.get(name, device="cpu", pretrained_weights=tag)
    jm = jax_models.get(name, pretrained_weights=tag)
    src = torch.load(str(mirror / os.path.basename(pretrained_models.get_pretrained_url(name, tag))))["net"]
    assert all(torch.equal(v, src[k]) for k, v in pm.net.state_dict().items())
    x = np.random.RandomState(1).rand(2, side, side, 3).astype(np.float32)
    ref = jax.jit(functools.partial(jm.module.apply, train=False))(jm.variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm.net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    g, r = (got, ref) if field is None else (getattr(got, field), getattr(ref, field))
    np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4, rtol=1e-4)
    assert pm.class_names == jm.class_names
    for attr in ("_default_nms_conf", "_default_nms_iou"):
        assert getattr(pm, attr, None) == getattr(jm, attr, None), attr
    assert_same_processing(pm.get_processing_params(), jm.get_processing_params())
    assert pm.num_params() == jm.num_params()


def test_checkpoint_path_with_pretrained_weights_attaches_the_processing(tmp_path, monkeypatch):
    """``checkpoint_path=`` wins over the mirror (empty here), and the COCO processing of the
    tag is attached all the same, as in JAX."""
    monkeypatch.setenv("SG_PRETRAINED_DIR", str(tmp_path / "empty"))
    src = models.get("yolo_nas_s", num_classes=80, device="cpu", seed=3)
    path = str(tmp_path / "own.pth")
    torch.save({"net": src.net.state_dict()}, path)
    pm = models.get("yolo_nas_s", device="cpu", image_size=64, pretrained_weights="coco", checkpoint_path=path)
    assert all(torch.equal(v, src.net.state_dict()[k]) for k, v in pm.net.state_dict().items())
    params = processing.default_yolo_nas_coco_processing_params()
    assert pm.class_names == params["class_names"] and (pm._default_nms_conf, pm._default_nms_iou) == (0.25, 0.7)
    assert_same_processing(pm.get_processing_params(), params["image_processor"])
    with pytest.raises(ValueError, match="no pretrained weights published"):
        models.get("mobilenet_v1", device="cpu", pretrained_weights="imagenet")


def test_processing_params_api_matches_jax():
    """Each argument sets its attribute, ``None`` keeps it, the deploy networks are dropped;
    ``replace_head`` keeps every tensor but the head's and the processing."""
    pm = models.get("yolo_nas_pose_n", device="cpu", image_size=64)
    pm._deploy_net(False, False)
    proc = processing.ComposeProcessing([processing.StandardizeImage(255.0)])
    pm.set_dataset_processing_params(class_names=("a", "b"), image_processor=proc, conf=0.4, iou=0.5,
                                     edge_links=[[0, 1]], edge_colors=[(1, 2, 3)], keypoint_colors=[(4, 5, 6)])
    assert pm.class_names == ["a", "b"] and pm.get_processing_params() is proc and not pm._deploy_nets
    assert (pm._default_nms_conf, pm._default_nms_iou, pm._edge_links) == (0.4, 0.5, [[0, 1]])
    assert (pm._edge_colors, pm._keypoint_colors) == ([(1, 2, 3)], [(4, 5, 6)])
    pm.set_dataset_processing_params(conf=None, class_names=None, unknown="ignored")
    assert pm._default_nms_conf == 0.4 and pm.class_names == ["a", "b"]

    base = models.get("resnet18_cifar", num_classes=10, device="cpu", seed=1)
    base.set_dataset_processing_params(image_processor=proc)
    new = base.replace_head(4, seed=2)
    assert new.num_classes == 4 and new.get_processing_params() is proc
    old_sd, new_sd = base.net.state_dict(), new.net.state_dict()
    assert all(torch.equal(v, old_sd[k]) for k, v in new_sd.items() if not k.startswith("linear."))
    assert new_sd["linear.weight"].shape == (4, 512) and base.num_params() - new.num_params() == 6 * 512 + 6


class _DS(torch.utils.data.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        return torch.zeros(3, 32, 32), i % 3

    def get_dataset_preprocessing_params(self):
        return {"class_names": ["a", "b", "c"]}


def test_trainer_sets_dataset_processing_params(tmp_path):
    """After ``train()`` the model carries the train dataset's class names (the JAX test's
    case, ``tests/test_transfer_learning.py``)."""
    m = models.get("resnet18_cifar", num_classes=3, device="cpu")
    assert m.class_names is None
    Trainer("handoff", ckpt_root_dir=str(tmp_path)).train(
        model=m,
        training_params={"max_epochs": 1, "initial_lr": 1e-3, "loss": "CrossEntropyLoss", "optimizer": "SGD",
                         "metric_to_watch": "train_loss", "greater_metric_to_watch_is_better": False, "ema": False,
                         "average_best_models": False, "sg_logger_params": {"tensorboard": False}},
        train_loader=DataLoader(_DS(), batch_size=8),
    )
    assert m.class_names == ["a", "b", "c"]
