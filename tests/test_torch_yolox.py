"""YOLOX of the PyTorch port against the JAX package's, on the same weights.

YOLOX-N (width 0.25, depth 0.33), 4 classes, 64x64 inputs, fp32. The JAX variables go to
the port through ``variables_from_jax_to_torch(YOLOX_RULES)`` with
``load_state_dict(strict=True)``. At the JAX init the objectness and class biases sit at
the 0.01 prior, so every score is about 1e-4: the fixture sets those biases to 0 and
draws the three prediction kernels from a seeded normal, scaled so the class and
objectness logits spread with a standard deviation of 2 and the box regression with
0.5. Tolerances: scores ``atol=5e-4``, boxes ``atol=5e-2, rtol=1e-3`` px, the raw logits
and regression ``atol=1e-2, rtol=1e-3``; predict() detections equal in count and labels,
boxes to 5e-2 px and scores to 5e-4. YOLOX suppresses on its ``obj * cls`` score map
(``scores_are_logits=False``), which these tests pin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from parity_utils import assert_close
from super_gradients_tpu.conversion.torch_converter import convert_state_dict, yolox_key_mapper
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.common.config import load_arch_params
from super_gradients_tpu_torch.common.registry import ARCHITECTURES
from super_gradients_tpu_torch.conversion.from_jax import YOLOX_RULES, variables_from_jax_to_torch
from super_gradients_tpu_torch.models.detection import yolox
from super_gradients_tpu_torch.models.sg_model import DetectionModel
from test_torch_ppyoloe_model import SIZES, _images, _port_forward, _x, assert_predictions_equal, numpy_variables
from torch_jax_init import jax_model

torch.set_num_threads(2)

SCALES = {"cls_pred": 2.0, "obj_pred": 2.0, "reg_pred": 0.5}
FIELDS = {"cls_pred": "cls_logits", "obj_pred": "obj_logits", "reg_pred": "reg_raw"}


def spread_yolox_head(jm, v, train=False, seed=0):
    """Prediction kernels from a seeded normal, scaled to :data:`SCALES` on seeded noise
    (in train or eval mode), objectness and class biases at 0."""
    rng = np.random.RandomState(seed)
    p = v["params"]
    for k in sorted(p):
        if k.startswith("head") and k.split("_", 1)[1] in SCALES:
            p[k]["kernel"][:] = rng.randn(*p[k]["kernel"].shape)
            p[k]["bias"][:] = 0.0
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    out = jm.apply(jnp.asarray(np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)), train=train)
    out = out[0] if train else out
    for k in p:
        if k.startswith("head") and k.split("_", 1)[1] in SCALES:
            kind = k.split("_", 1)[1]
            p[k]["kernel"][:] *= SCALES[kind] / np.std(np.asarray(getattr(out, FIELDS[kind])))
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    return v


def yolox_pair(train=False):
    jm = jax_model("yolox_n", num_classes=4, image_size=64)
    v = spread_yolox_head(jm, numpy_variables(jm), train=train)
    pm = models.get("yolox_n", num_classes=4, image_size=64, device="cpu")
    pm.net.load_state_dict(variables_from_jax_to_torch(v, YOLOX_RULES), strict=True)
    return jm, v, pm


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its numpy variables, port model on the CPU carrying them)."""
    return yolox_pair()


def compare_outputs(jax_out, port_out):
    assert type(port_out).__name__ == "YoloXOutputs"
    assert_close(port_out.pred_scores.numpy(), np.asarray(jax_out.pred_scores), atol=5e-4, name="pred_scores")
    assert_close(port_out.pred_bboxes.numpy(), np.asarray(jax_out.pred_bboxes), atol=5e-2, rtol=1e-3, name="pred_bboxes")
    for f in ("cls_logits", "obj_logits", "reg_raw"):
        assert_close(getattr(port_out, f).numpy(), np.asarray(getattr(jax_out, f)), atol=1e-2, rtol=1e-3, name=f)
    np.testing.assert_array_equal(port_out.anchor_points.numpy(), np.asarray(jax_out.anchor_points))
    np.testing.assert_array_equal(port_out.stride_tensor.numpy(), np.asarray(jax_out.stride_tensor))
    assert port_out.num_anchors_list == tuple(jax_out.num_anchors_list) == (64, 16, 4)


def test_outputs_spread(pair):
    jm, _, _ = pair
    out = jm.apply(jnp.asarray(_x(3)))
    assert np.std(np.asarray(out.cls_logits)) > 1.0 and np.std(np.asarray(out.obj_logits)) > 1.0
    assert np.asarray(out.pred_scores).max() > 0.5


def test_forward_matches_jax(pair):
    jm, _, pm = pair
    x = _x()
    out = _port_forward(pm.net, x)
    compare_outputs(jm.apply(jnp.asarray(x)), out)
    # anchor points without the half-cell offset, the regression clipped before exp
    assert out.anchor_points[:2].tolist() == [[0.0, 0.0], [1.0, 0.0]]


def test_forward_train_mode_matches_jax():
    """Train mode (BatchNorm on the batch's statistics), with the head scaled on
    train-mode outputs."""
    jm, _, pm = yolox_pair(train=True)
    x = _x(4)
    ref, _ = jm.apply(jnp.asarray(x), train=True)
    net = pm.net.train()
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    compare_outputs(ref, out)


def test_decode_clips_regression():
    """``exp`` of the size regression clipped to [-10, 8], as in JAX."""
    model = models.get("yolox_n", num_classes=2, image_size=64, device="cpu")
    for m in model.net._head._modules_list[14].reg_preds:
        torch.nn.init.zeros_(m.weight)
        m.bias.data = torch.tensor([0.0, 0.0, 50.0, -50.0])
    out = _port_forward(model.net, _x()[:1])
    wh = out.pred_bboxes[..., 2:] - out.pred_bboxes[..., :2]
    torch.testing.assert_close(wh[0, 0], torch.tensor([np.exp(8.0) * 8, np.exp(-10.0) * 8], dtype=torch.float32))


def test_upsample_equals_jax_nearest():
    """The PAFPN's 2x nearest upsampling equals ``jax.image.resize(..., "nearest")``."""
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (2, 10, 14, 3), "nearest"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    np.testing.assert_array_equal(yolox._Upsample2x()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(),
                                  got.numpy())


def test_fuse_is_a_no_op(pair):
    jm, _, pm = pair
    assert pm.fuse() is pm and jm.fuse() is jm


def test_state_dict_round_trips_through_jax_converter(pair):
    jm, v, pm = pair
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    back = convert_state_dict(pm.net.state_dict(), template, rules=yolox_key_mapper(), strict=True)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(v))
    assert len(flat_back) == len(jax.tree_util.tree_leaves(template))
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_ref[path], err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("fuse_model", [True, False])
def test_predict_fp32_matches_jax(pair, fuse_model):
    jm, _, pm = pair
    images = _images()
    ref = jm.predict(images, bf16=False, fuse_model=fuse_model, conf=0.1)
    got = pm.predict(images, bf16=False, fuse_model=fuse_model, conf=0.1)
    assert_predictions_equal(got, ref, len(SIZES))


def test_predict_batch_tensor_suppresses_on_score_map(pair, monkeypatch):
    """YOLOX's scores are ``sigmoid(obj) * sigmoid(cls)``, not a sigmoid of one logit map:
    the NMS takes ``pred_scores`` with ``scores_are_logits=False``, as the JAX program
    chooses by output type. Suppressing on ``cls_logits`` (the port's earlier fixed
    choice) gives other detections here."""
    from super_gradients_tpu_torch.models import sg_model
    from super_gradients_tpu_torch.ops.nms import batched_nms

    jm, _, pm = pair
    x = _x(2)
    seen = []
    original = sg_model.batched_nms
    monkeypatch.setattr(sg_model, "batched_nms", lambda *a, **k: seen.append((a, k)) or original(*a, **k))
    got = pm.predict_batch_tensor(torch.from_numpy(x), bf16=False, conf=0.1)
    (args, kwargs), = seen
    with torch.no_grad():  # the NHWC batch permuted, as predict feeds it
        out = pm.net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert kwargs["scores_are_logits"] is False
    torch.testing.assert_close(args[1], out.pred_scores, atol=0, rtol=0)
    ref = jm.predict_batch_tensor(jnp.asarray(x), bf16=False, conf=0.1)
    np.testing.assert_array_equal(got.num_detections.numpy(), np.asarray(ref.num_detections))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=5e-2, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=5e-4, rtol=0)
    assert (got.num_detections > 0).all()
    wrong = batched_nms(out.pred_bboxes, out.cls_logits, score_threshold=0.1, scores_are_logits=True)
    assert not torch.equal(wrong.scores, got.scores)


VARIANTS = {"yolox_n": (0.33, 0.25), "yolox_t": (0.33, 0.375), "yolox_s": (0.33, 0.5), "yolox_m": (0.67, 0.75),
            "yolox_l": (1.0, 1.0), "yolox_x": (1.33, 1.25), "custom_yolox": (1.0, 1.0)}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_registrations_match_jax(name):
    """All seven names build on the CPU on request, with the JAX zoo's config and
    parameter shapes (the width cut by arch_params where the builder reads it, so the
    big ones stay small here); the default device is the card. ``yolox_x`` is built at
    640 whatever ``image_size`` says, as in JAX."""
    from super_gradients_tpu.common.registry import ARCHITECTURES as JAX_ARCHITECTURES

    assert name in ARCHITECTURES and name in JAX_ARCHITECTURES
    ap = {"depth_mult": 0.33, "width_mult": 0.125} if name == "custom_yolox" else \
        ({} if name == "yolox_x" else {"depth_mult_factor": 0.33, "width_mult_factor": 0.125})
    spec = ARCHITECTURES[name](num_classes=3, arch_params=ap, image_size=64)
    jspec = JAX_ARCHITECTURES[name](num_classes=3, arch_params=ap, image_size=64)
    assert (spec.config.depth, spec.config.width, spec.config.num_classes) == \
        (jspec.config.depth, jspec.config.width, jspec.config.num_classes)
    assert spec.input_hw == jspec.input_hw == ((640, 640) if name == "yolox_x" else (64, 64))
    depth, width = VARIANTS[name]
    if not ap:
        assert (spec.config.depth, spec.config.width) == (depth, width)
    else:
        jm = jax_model(name, num_classes=3, image_size=64, arch_params=ap)
        sd = variables_from_jax_to_torch(numpy_variables(jm), YOLOX_RULES)
        mine = spec.net.state_dict()
        assert sorted(sd) == sorted(mine)
        assert all(tuple(sd[k].shape) == tuple(mine[k].shape) for k in sd)
        model = models.get(name, num_classes=3, image_size=64, device="cpu", arch_params=ap)
        assert isinstance(model, DetectionModel) and model.device.type == "cpu"
        out = _port_forward(model.net, _x()[:1])
        assert out.pred_scores.shape == (1, 84, 3) and torch.isfinite(out.pred_bboxes).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.get(name, num_classes=3, image_size=64, arch_params=ap)


@pytest.mark.parametrize("variant,file", [("yolox_n", "yolox_nano"), ("yolox_t", "yolox_tiny"), ("yolox_s", "yolox_s"),
                                          ("yolox_m", "yolox_m"), ("yolox_l", "yolox_l")])
def test_arch_params_yamls_reshape_as_in_jax(variant, file):
    """``load_arch_params("yolox_*_arch_params")`` (with its ``yolo_arch_params`` defaults)
    reshapes any variant to that file's depth and width, in both zoos."""
    from super_gradients_tpu.common.config import load_arch_params as jax_load_arch_params
    from super_gradients_tpu.common.registry import ARCHITECTURES as JAX_ARCHITECTURES

    ap = load_arch_params(f"{file}_arch_params")
    assert ap == jax_load_arch_params(f"{file}_arch_params")
    spec = ARCHITECTURES["yolox_l"](num_classes=2, arch_params=ap, image_size=64)
    jspec = JAX_ARCHITECTURES["yolox_l"](num_classes=2, arch_params=ap, image_size=64)
    assert (spec.config.depth, spec.config.width) == (jspec.config.depth, jspec.config.width) == VARIANTS[variant]
