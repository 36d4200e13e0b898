"""PP-YOLOE of the PyTorch port against the JAX package's, on the same weights.

PP-YOLOE-S cut by its arch_params override to ``width_mult`` 0.25 (depth 0.33), 4
classes, 64x64 inputs, fp32. The JAX model's variables go to the port through
``variables_from_jax_to_torch(PPYOLOE_RULES)`` with ``load_state_dict(strict=True)``.
The JAX init gives the prediction convs zero kernels (every class score 0.01, every box
alike), so the fixture draws the ``pred_cls`` / ``pred_reg`` kernels from a seeded
normal, scaled so the logits and the DFL logits spread with a standard deviation of 2,
and sets the class biases to 0 so that random weights detect something. Tolerances are
``tests/parity_utils.py``'s: ``pred_scores`` ``atol=5e-4``, ``pred_bboxes`` ``atol=5e-2,
rtol=1e-3`` px, the raw logits ``atol=1e-2, rtol=1e-3``; predict() detections equal in
count and labels, boxes to 5e-2 px and scores to 5e-4.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import assert_close
from super_gradients_tpu.conversion.torch_converter import convert_state_dict, ppyoloe_key_mapper
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.common.config import load_arch_params
from super_gradients_tpu_torch.conversion.from_jax import PPYOLOE_RULES, variables_from_jax_to_torch
from super_gradients_tpu_torch.models.detection import pp_yolo_e
from super_gradients_tpu_torch.models.sg_model import DetectionModel
from super_gradients_tpu_torch.modules.blocks import RepVGGBlock
from torch_jax_init import jax_model

torch.set_num_threads(2)

AP = {"width_mult": 0.25, "depth_mult": 0.33}
SIZES = ((50, 70), (64, 64), (97, 33))


def numpy_variables(model):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), jax.device_get(model.variables))


def spread_head(jm, v, seed=0):
    """``pred_cls`` / ``pred_reg`` kernels from a seeded normal, scaled so the class and DFL
    logits have a standard deviation of 2 on seeded noise, class biases at 0."""
    rng = np.random.RandomState(seed)
    head = v["params"]["head"]
    for k in sorted(head):
        if k.startswith(("pred_cls", "pred_reg")):
            head[k]["kernel"][:] = rng.randn(*head[k]["kernel"].shape)
        if k.startswith("pred_cls"):
            head[k]["bias"][:] = 0.0
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    out = jm.apply(jnp.asarray(np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)))
    scale = {"pred_cls": 2.0 / np.std(np.asarray(out.cls_logits)), "pred_reg": 2.0 / np.std(np.asarray(out.reg_distri))}
    for k in head:
        for prefix, s in scale.items():
            if k.startswith(prefix):
                head[k]["kernel"][:] *= s
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    return v


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its numpy variables, port model on the CPU carrying them)."""
    jm = jax_model("ppyoloe_s", num_classes=4, image_size=64, arch_params=AP)
    v = spread_head(jm, numpy_variables(jm))
    pm = models.get("ppyoloe_s", num_classes=4, image_size=64, device="cpu", arch_params=AP)
    pm.net.load_state_dict(variables_from_jax_to_torch(v, PPYOLOE_RULES), strict=True)
    return jm, v, pm


def _x(seed=0):
    return np.random.RandomState(seed).rand(2, 64, 64, 3).astype(np.float32)


def _port_forward(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())


def compare_outputs(jax_out, port_out):
    assert type(port_out).__name__ == "YoloNASOutputs"
    assert_close(port_out.pred_scores.numpy(), np.asarray(jax_out.pred_scores), atol=5e-4, name="pred_scores")
    assert_close(port_out.pred_bboxes.numpy(), np.asarray(jax_out.pred_bboxes), atol=5e-2, rtol=1e-3, name="pred_bboxes")
    assert_close(port_out.cls_logits.numpy(), np.asarray(jax_out.cls_logits), atol=1e-2, rtol=1e-3, name="cls_logits")
    assert_close(port_out.reg_distri.numpy(), np.asarray(jax_out.reg_distri), atol=1e-2, rtol=1e-3, name="reg_distri")
    np.testing.assert_array_equal(port_out.anchor_points.numpy(), np.asarray(jax_out.anchor_points))
    np.testing.assert_array_equal(port_out.stride_tensor.numpy(), np.asarray(jax_out.stride_tensor))
    assert port_out.num_anchors_list == tuple(jax_out.num_anchors_list) == (4, 16, 64)


def test_outputs_spread(pair):
    """The fixture's head reaches every class and spreads the DFL bins (no vacuous ties)."""
    jm, _, _ = pair
    out = jm.apply(jnp.asarray(_x(3)))
    assert np.std(np.asarray(out.cls_logits)) > 1.0 and np.std(np.asarray(out.reg_distri)) > 1.0
    assert len(np.unique(np.asarray(out.pred_bboxes).round(3))) > 100


def test_forward_unfused_matches_jax(pair):
    jm, _, pm = pair
    x = _x()
    compare_outputs(jm.apply(jnp.asarray(x)), _port_forward(pm.net, x))


def test_forward_train_mode_matches_jax(pair):
    """Train mode: BatchNorm on the batch's statistics, and the running statistics it
    leaves behind (momentum 0.1 in torch's convention, 0.9 in flax's). Batch statistics
    make the features far larger than in eval mode, so the head kernels are scaled
    down again for train-mode logits of standard deviation 2."""
    jm, v, _ = pair
    x = _x(4)
    ref, _ = jm.apply(jnp.asarray(x), train=True)
    v = jax.tree_util.tree_map(np.copy, v)
    for k, sub in v["params"]["head"].items():
        if k.startswith("pred_cls"):
            sub["kernel"][:] *= 2.0 / np.std(np.asarray(ref.cls_logits))
        if k.startswith("pred_reg"):
            sub["kernel"][:] *= 2.0 / np.std(np.asarray(ref.reg_distri))
    jm2 = jax_model("ppyoloe_s", num_classes=4, image_size=64, arch_params=AP)
    jm2.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    ref, updates = jm2.apply(jnp.asarray(x), train=True)
    net = models.get("ppyoloe_s", num_classes=4, image_size=64, device="cpu", arch_params=AP).net
    net.load_state_dict(variables_from_jax_to_torch(v, PPYOLOE_RULES), strict=True)
    net.train()
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert np.std(np.asarray(ref.cls_logits)) > 1.0
    compare_outputs(ref, out)
    stats = updates["batch_stats"]["backbone"]["stem_conv1"]["bn"]
    bn = net.backbone.stem.conv1.seq.bn
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5, rtol=1e-4)
    # flax keeps the biased batch variance, torch the unbiased one
    n = 2 * 32 * 32
    np.testing.assert_allclose(bn.running_var.numpy() - 0.9, (np.asarray(stats["var"]) - 0.9) * n / (n - 1),
                               atol=1e-5, rtol=1e-4)


def test_forward_fused_matches_jax(pair):
    jm, _, pm = pair
    x = _x(1)
    jfused = jm.fuse()
    ref = jfused.apply(jnp.asarray(x))
    compare_outputs(ref, _port_forward(pm.fuse().net, x))  # fused in place by the port
    built = models.get("ppyoloe_s", num_classes=4, image_size=64, device="cpu", arch_params={**AP, "fused": "full"})
    built.net.load_state_dict(variables_from_jax_to_torch(numpy_variables(jfused), PPYOLOE_RULES), strict=True)
    compare_outputs(ref, _port_forward(built.net, x))


def test_fuse_leaves_model_unfused_and_matches_it(pair):
    _, _, pm = pair
    x = _x(2)
    fused = pm.fuse()
    assert fused is not pm and fused.config.fused and not pm.config.fused
    assert sum(isinstance(m, RepVGGBlock) for m in pm.net.modules()) > 0
    assert any(k.endswith("conv2.branch_1x1.bn.running_var") for k in pm.net.state_dict())
    assert not any("branch_" in k for k in fused.net.state_dict())
    a, b = _port_forward(pm.net, x), _port_forward(fused.net, x)
    np.testing.assert_allclose(b.pred_scores.numpy(), a.pred_scores.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(b.pred_bboxes.numpy(), a.pred_bboxes.numpy(), atol=1e-2, rtol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_state_dict_round_trips_through_jax_converter(pair, fused):
    jm, v, pm = pair
    if fused:
        jm = jm.fuse()
        v = numpy_variables(jm)
        pm = models.get("ppyoloe_s", num_classes=4, image_size=64, device="cpu", arch_params={**AP, "fused": "full"})
        pm.net.load_state_dict(variables_from_jax_to_torch(v, PPYOLOE_RULES), strict=True)
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    back = convert_state_dict(pm.net.state_dict(), template, rules=ppyoloe_key_mapper(), strict=True)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(v))
    assert len(flat_back) == len(jax.tree_util.tree_leaves(template))
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_ref[path], err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,width,depth", [("ppyoloe_s", 0.5, 0.33), ("ppyoloe_m", 0.75, 0.67),
                                              ("ppyoloe_l", 1.0, 1.0), ("ppyoloe_x", 1.25, 1.33)])
def test_configs_and_arch_params_override_match_jax(name, width, depth):
    """Each variant's config, and the width / depth that its arch_params YAML sets on
    another variant, as in the JAX zoo; the parameter shapes equal the JAX tree's."""
    from super_gradients_tpu.models.all_models import _ppyoloe_spec

    from super_gradients_tpu.models.detection import pp_yolo_e as jax_pp

    ap = load_arch_params(f"{name}_arch_params")
    assert (ap["width_mult"], ap["depth_mult"]) == (width, depth)
    jcfg = _ppyoloe_spec(getattr(jax_pp, f"{name}_config"), num_classes=3, arch_params={**AP, **ap}).config
    spec = models.all_models._ppyoloe_spec(pp_yolo_e.ppyoloe_s_config, num_classes=3, arch_params=ap, image_size=64)
    assert (spec.config.width_mult, spec.config.depth_mult) == (jcfg.width_mult, jcfg.depth_mult) == (width, depth)
    assert spec.config.num_classes == 3 and spec.input_hw == (64, 64)
    if name == "ppyoloe_s":
        jm = jax_model("ppyoloe_s", num_classes=3, image_size=64, arch_params=ap)
        sd = variables_from_jax_to_torch(numpy_variables(jm), PPYOLOE_RULES)
        mine = spec.net.state_dict()
        assert sorted(sd) == sorted(mine)
        assert all(tuple(sd[k].shape) == tuple(mine[k].shape) for k in sd)


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SIZES]


def assert_predictions_equal(got, ref, n_images):
    assert len(got) == len(ref) == n_images
    total = 0
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        np.testing.assert_array_equal(g.labels, r.labels)
        np.testing.assert_allclose(g.bboxes_xyxy, r.bboxes_xyxy, atol=5e-2, rtol=0)
        np.testing.assert_allclose(g.confidence, r.confidence, atol=5e-4, rtol=0)
        assert g.image.shape == r.image.shape
        total += len(g)
    assert total > 0


@pytest.mark.parametrize("fuse_model", [True, False])
def test_predict_fp32_matches_jax(pair, fuse_model):
    jm, _, pm = pair
    images = _images()
    ref = jm.predict(images, bf16=False, fuse_model=fuse_model, conf=0.1)
    got = pm.predict(images, bf16=False, fuse_model=fuse_model, conf=0.1)
    assert_predictions_equal(got, ref, len(SIZES))


def test_predict_batch_tensor_suppresses_on_logits(pair, monkeypatch):
    """PP-YOLOE returns ``YoloNASOutputs``: the NMS takes ``cls_logits`` with
    ``scores_are_logits=True``, as the JAX program chooses, and the result equals JAX's."""
    from super_gradients_tpu_torch.models import sg_model

    jm, _, pm = pair
    x = _x(2)
    seen = []
    original = sg_model.batched_nms
    monkeypatch.setattr(sg_model, "batched_nms", lambda *a, **k: seen.append((a, k)) or original(*a, **k))
    got = pm.predict_batch_tensor(torch.from_numpy(x), bf16=False, conf=0.1)
    (args, kwargs), = seen
    assert kwargs["scores_are_logits"] is True and args[1].shape[-1] == 4
    with torch.no_grad():  # the NHWC batch permuted, as predict feeds it
        out = pm._deploy_net(True, False)(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch.testing.assert_close(args[1], out.cls_logits, atol=0, rtol=0)
    ref = jm.predict_batch_tensor(jnp.asarray(x), bf16=False, conf=0.1)
    np.testing.assert_array_equal(got.num_detections.numpy(), np.asarray(ref.num_detections))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=5e-2, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=5e-4, rtol=0)
    assert (got.num_detections > 0).all()


@pytest.mark.parametrize("name", ["ppyoloe_s", "ppyoloe_m", "ppyoloe_l", "ppyoloe_x"])
def test_models_get_on_cpu_and_cuda_default(name):
    """Every variant builds on the CPU on request and runs; the default device is the card."""
    model = models.get(name, num_classes=2, image_size=64, device="cpu", arch_params={"width_mult": 0.25})
    assert isinstance(model, DetectionModel) and model.device.type == "cpu"
    assert isinstance(model.net, pp_yolo_e.PPYoloE) and model.class_names is None
    out = _port_forward(model.net, _x()[:1])
    assert out.pred_bboxes.shape == (1, 84, 4) and torch.isfinite(out.pred_bboxes).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.get(name, num_classes=2, image_size=64)


def test_random_init_keeps_jax_head_init():
    """``models.get`` keeps the JAX head init: zero prediction kernels, the class prior
    bias and a unit DFL bias, so every score is 0.01."""
    model = models.get("ppyoloe_s", num_classes=3, image_size=64, device="cpu", arch_params=AP)
    for i in range(3):
        assert not model.net.head.pred_cls[i].weight.any() and not model.net.head.pred_reg[i].weight.any()
        assert torch.all(model.net.head.pred_reg[i].bias == 1.0)
    out = _port_forward(model.net, _x())
    torch.testing.assert_close(out.pred_scores, torch.full_like(out.pred_scores, 0.01), atol=1e-6, rtol=0)
    assert dataclasses.asdict(model.config)["grid_cell_offset"] == 0.5
