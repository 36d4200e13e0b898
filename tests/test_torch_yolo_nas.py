"""YOLO-NAS of the PyTorch port against the JAX package's, on the same weights.

YOLO-NAS-S, ``num_classes=4``, 64x64, eval, fp32. The JAX model's variables (the
``cls_pred`` biases set to 0) go to the port through ``variables_from_jax_to_torch``
with ``load_state_dict(strict=True)``. Tolerances are those of
``tests/parity_utils.py:126-128``: ``pred_scores`` ``atol=5e-4``, ``pred_bboxes``
``atol=5e-2, rtol=1e-3`` (pixel units); the raw logits get ``atol=1e-2, rtol=1e-3``.
The port's ``state_dict`` converted back by the JAX package's own converter must
give the JAX variables exactly, which holds the port's copy of the name rules to
the JAX converter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import assert_close
from super_gradients_tpu.conversion.torch_converter import convert_state_dict, yolo_nas_key_mapper
from super_gradients_tpu.models.detection import yolo_nas as jax_yolo_nas
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.models.detection import yolo_nas
from torch_jax_init import jax_model

torch.set_num_threads(2)


def jax_numpy_variables(model):
    """Writable numpy copy of a JAX model's variables, every cls_pred bias at 0
    (with the -log(99) prior every random-init score is ~0.01 and nothing is detected)."""
    v = jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), jax.device_get(model.variables))
    for name, head in v["params"]["heads"].items():
        head["cls_pred"]["bias"][:] = 0.0
    return v


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its numpy variables, port model on CPU carrying them)."""
    jm = jax_model("yolo_nas_s", num_classes=4, image_size=64)
    v = jax_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    pm = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu")
    pm.net.load_state_dict(variables_from_jax_to_torch(v), strict=True)
    return jm, v, pm


def _x(seed=0):
    return np.random.RandomState(seed).rand(2, 64, 64, 3).astype(np.float32)


def _compare(jax_out, port_out):
    assert_close(port_out.pred_scores.numpy(), np.asarray(jax_out.pred_scores), atol=5e-4, name="pred_scores")
    assert_close(port_out.pred_bboxes.numpy(), np.asarray(jax_out.pred_bboxes), atol=5e-2, rtol=1e-3, name="pred_bboxes")
    assert_close(port_out.cls_logits.numpy(), np.asarray(jax_out.cls_logits), atol=1e-2, rtol=1e-3, name="cls_logits")
    np.testing.assert_array_equal(port_out.anchor_points.numpy(), np.asarray(jax_out.anchor_points))
    np.testing.assert_array_equal(port_out.stride_tensor.numpy(), np.asarray(jax_out.stride_tensor))
    assert port_out.num_anchors_list == tuple(jax_out.num_anchors_list) == (64, 16, 4)


def _port_forward(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())


def test_forward_unfused_matches_jax(pair):
    jm, _, pm = pair
    x = _x()
    _compare(jm.apply(jnp.asarray(x)), _port_forward(pm.net, x))


def test_forward_fused_matches_jax(pair):
    jm, _, pm = pair
    x = _x(1)
    jfused = jm.fuse()
    ref = jfused.apply(jnp.asarray(x))
    # fused in place by the port's own re-parameterization
    _compare(ref, _port_forward(pm.fuse().net, x))
    # built fused and loaded from the JAX fused tree
    built = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu", arch_params={"fused": "full"})
    fused_vars = jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), jax.device_get(jfused.variables))
    built.net.load_state_dict(variables_from_jax_to_torch(fused_vars), strict=True)
    _compare(ref, _port_forward(built.net, x))


def test_fuse_leaves_model_unfused_and_matches_it(pair):
    _, _, pm = pair
    x = _x(2)
    fused = pm.fuse()
    assert fused is not pm and fused.config.fused and not pm.config.fused
    assert any(k.endswith("branch_3x3.conv.weight") for k in pm.net.state_dict())
    assert not any("branch_" in k for k in fused.net.state_dict())
    a, b = _port_forward(pm.net, x), _port_forward(fused.net, x)
    np.testing.assert_allclose(b.pred_scores.numpy(), a.pred_scores.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(b.pred_bboxes.numpy(), a.pred_bboxes.numpy(), atol=1e-2, rtol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_state_dict_round_trips_through_jax_converter(pair, fused):
    jm, v, pm = pair
    if fused:
        jm = jm.fuse()
        v = jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), jax.device_get(jm.variables))
        pm = models.get("yolo_nas_s", num_classes=4, image_size=64, device="cpu", arch_params={"fused": "full"})
        pm.net.load_state_dict(variables_from_jax_to_torch(v), strict=True)
    # the template holds exactly what the JAX module reads (the JAX fuse() also keeps
    # the folded BNs' statistics, which no module reads and the port drops)
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    back = convert_state_dict(pm.net.state_dict(), template, rules=yolo_nas_key_mapper(), strict=True)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(v))
    assert len(flat_back) == len(jax.tree_util.tree_leaves(template))
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_ref[path], err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("variant", ["s", "m", "l"])
def test_variant_configs_and_shapes_match_jax(variant):
    """Each config equals the JAX one field for field, and the port's state_dict has
    exactly the keys and shapes of the JAX variables (eval_shape: nothing is compiled)."""
    jcfg = getattr(jax_yolo_nas, f"yolo_nas_{variant}_config")(num_classes=80)
    pcfg = getattr(yolo_nas, f"yolo_nas_{variant}_config")(num_classes=80)
    j = {k: val for k, val in dataclasses.asdict(jcfg).items() if k not in ("fused", "stem_s2d")}
    p = {k: val for k, val in dataclasses.asdict(pcfg).items() if k != "fused"}
    assert j == p
    shapes = jax.eval_shape(jax_yolo_nas.YoloNAS(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    expected = {k: tuple(t.shape) for k, t in variables_from_jax_to_torch(zeros).items()}
    got = {k: tuple(t.shape) for k, t in yolo_nas.YoloNAS(pcfg).state_dict().items()}
    assert got == expected
