"""YOLO-NAS-POSE of the PyTorch port against the JAX package's, on the same weights.

YOLO-NAS-POSE N and S, 17 joints, 64x64, fp32. The JAX model's variables (flax's default
initializers over the traced init, the kernels from a numpy seed: every ``cls_pred`` bias
0) go to the port through ``variables_from_jax_to_torch(v,
rules=YOLO_NAS_POSE_RULES)`` with ``load_state_dict(strict=True)``. Tolerances (those
of ``tests/parity_utils.py``): ``pred_scores`` and ``pred_pose_scores`` ``atol=5e-4``;
``pred_bboxes`` and ``pred_pose_coords`` ``atol=5e-2, rtol=1e-3`` (pixels); the raw
logits ``atol=1e-2, rtol=1e-3``. Eval mode (unfused, and fused: the port's
re-parameterization against the JAX ``fuse_all_qarepvgg``) and train-mode BatchNorm
(against the JAX forward in fp64, see its test). The port's
``state_dict`` converted back by the JAX ``convert_state_dict(...,
yolo_nas_pose_key_mapper())`` gives the JAX variables exactly.
"""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import assert_close
from super_gradients_tpu import models as jax_models
from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu.conversion.torch_converter import convert_state_dict, yolo_nas_pose_key_mapper
from super_gradients_tpu.models.pose import yolo_nas_pose as jax_pose
from super_gradients_tpu.modules.blocks import fuse_all_qarepvgg
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.conversion.from_jax import YOLO_NAS_POSE_RULES, variables_from_jax_to_torch
from super_gradients_tpu_torch.models.model_factory import _calibrate_batch_norm
from super_gradients_tpu_torch.models.pose import yolo_nas_pose
from torch_jax_init import FP64_COMPILE, flax_like_variables

torch.set_num_threads(2)
SIDE = 64


def jax_pose_numpy_variables(model):
    """Writable numpy copy of a JAX pose model's variables, every cls_pred bias at 0."""
    v = jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), jax.device_get(model.variables))
    for name, sub in v["params"].items():
        if name.startswith("head"):
            sub["cls_pred"]["bias"][:] = 0.0
    return v


def pose_pair(variant):
    """(JAX model, its numpy variables, port model on CPU carrying them): the JAX zoo's module
    and config with flax's default initializers drawn from numpy seed 0 (no compiled init)."""
    spec = jax_models.get_architecture(f"yolo_nas_pose_{variant}")(num_classes=None, arch_params={}, image_size=SIDE)
    v = flax_like_variables(spec.module, (1, SIDE, SIDE, 3), seed=0)
    jm = types.SimpleNamespace(module=spec.module, config=spec.config,
                               variables=jax.tree_util.tree_map(jnp.asarray, v))
    pm = models.get(f"yolo_nas_pose_{variant}", image_size=SIDE, device="cpu")
    pm.net.load_state_dict(variables_from_jax_to_torch(v, rules=YOLO_NAS_POSE_RULES), strict=True)
    return jm, v, pm


@pytest.fixture(scope="module", params=["n", "s"])
def pair(request):
    return pose_pair(request.param)


def _x(seed=0):
    return np.random.RandomState(seed).rand(2, SIDE, SIDE, 3).astype(np.float32)


def compare_pose_outputs(jax_out, port_out):
    assert_close(port_out.pred_scores.numpy(), np.asarray(jax_out.pred_scores), atol=5e-4, name="pred_scores")
    assert_close(port_out.pred_pose_scores.numpy(), np.asarray(jax_out.pred_pose_scores), atol=5e-4,
                 name="pred_pose_scores")
    assert_close(port_out.pred_bboxes.numpy(), np.asarray(jax_out.pred_bboxes), atol=5e-2, rtol=1e-3, name="pred_bboxes")
    assert_close(port_out.pred_pose_coords.numpy(), np.asarray(jax_out.pred_pose_coords), atol=5e-2, rtol=1e-3,
                 name="pred_pose_coords")
    for name in ("cls_logits", "pose_logits", "reg_distri"):
        assert_close(getattr(port_out, name).numpy(), np.asarray(getattr(jax_out, name)), atol=1e-2, rtol=1e-3, name=name)
    np.testing.assert_array_equal(port_out.anchor_points.numpy(), np.asarray(jax_out.anchor_points))
    np.testing.assert_array_equal(port_out.stride_tensor.numpy(), np.asarray(jax_out.stride_tensor))
    assert port_out.num_anchors_list == tuple(jax_out.num_anchors_list) == (64, 16, 4)


def _port_forward(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())


def _jax_forward(module, variables, x):
    """``module.apply`` in eval mode, compiled as one program."""
    return jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)


def test_forward_eval_matches_jax(pair):
    jm, _, pm = pair
    x = _x()
    compare_pose_outputs(_jax_forward(jm.module, jm.variables, jnp.asarray(x)), _port_forward(pm.net.eval(), x))


def test_forward_train_mode_bn_matches_jax(pair):
    """Batch statistics in the forward (train-mode BN). The random-init network is
    ill-conditioned in train mode (the N variant's stride-32 level normalizes 8 values a
    channel at this size), and the JAX fp32 forward lands further from the fp64 result
    than the port's (its BN takes E[x^2] - E[x]^2): the JAX reference runs in fp64 under
    ``jax.enable_x64`` (its decode in fp32, as written). The port in fp32 is held to it at
    the stated tolerances, the port in fp64 to its raw outputs at 1e-8."""
    jm, v, pm = pair
    x = _x(3)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), v)
        ref, _ = jax.jit(lambda v, x: jm.module.apply(v, x, train=True, mutable=["batch_stats"]),
                         compiler_options=FP64_COMPILE)(v64, jnp.asarray(x.astype(np.float64)))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    net = copy.deepcopy(pm.net).train()
    compare_pose_outputs(ref, _port_forward(net, x))
    got64 = _port_forward(net.double(), x.astype(np.float64))
    for name in ("cls_logits", "pose_logits", "reg_distri"):
        np.testing.assert_allclose(getattr(got64, name).numpy(), getattr(ref, name), atol=1e-8, rtol=0, err_msg=name)


def test_forward_fused_matches_jax(pair):
    """The port's own re-parameterization, and a model built fused and loaded from the
    JAX ``fuse_all_qarepvgg`` tree, against the JAX fused network."""
    jm, v, pm = pair
    x = _x(1)
    cfg = jm.config
    fparams, fstats = fuse_all_qarepvgg(v["params"], v["batch_stats"], bn_eps=cfg.bn_eps)
    fused_vars = {"params": fparams, "batch_stats": fstats}
    jfused = jax_pose.YoloNASPose(dataclasses.replace(cfg, base=dataclasses.replace(cfg.base, fused="full")))
    ref = _jax_forward(jfused, jax.tree_util.tree_map(jnp.asarray, fused_vars), jnp.asarray(x))
    fused = pm.fuse()
    assert fused is not pm and fused.config.fused and not pm.config.fused
    assert not any("branch_" in k for k in fused.net.state_dict())
    compare_pose_outputs(ref, _port_forward(fused.net, x))
    built = models.get(pm.name, image_size=SIDE, device="cpu", arch_params={"fused": "full"})
    np_vars = jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), fused_vars)
    built.net.load_state_dict(variables_from_jax_to_torch(np_vars, rules=YOLO_NAS_POSE_RULES), strict=True)
    compare_pose_outputs(ref, _port_forward(built.net, x))


def test_state_dict_round_trips_through_jax_converter(pair):
    jm, v, pm = pair
    template = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)))
    back = convert_state_dict(pm.net.state_dict(), template, rules=yolo_nas_pose_key_mapper(), strict=True)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(v))
    assert len(flat_back) == len(jax.tree_util.tree_leaves(template))
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_ref[path], err_msg=jax.tree_util.keystr(path))


def test_original_attribute_names(pair):
    _, _, pm = pair
    keys = set(pm.net.state_dict())
    for key in ("heads.head1.pose_stem.seq.conv.weight", "heads.head1.bbox_stem.seq.bn.running_var",
                "heads.head2.cls_convs.0.seq.conv.weight", "heads.head3.reg_convs.0.seq.bn.weight",
                "heads.head3.pose_convs.2.seq.conv.weight", "heads.head1.pose_pred.bias", "heads.head2.cls_pred.bias"):
        assert key in keys, key
    assert pm.net.state_dict()["heads.head1.cls_pred.bias"].shape == (18,)  # person + 17 joints


def _config_dict(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("fused", None)  # the port's top-level switch of the deploy form
    for k in ("fused", "stem_s2d"):
        d["base"].pop(k, None)
    return d


@pytest.mark.parametrize("variant", ["n", "s", "m", "l"])
def test_variant_configs_and_shapes_match_jax(variant):
    """Each config equals the JAX one field for field, the arch_params YAML gives the same
    config in both packages, and the port's state_dict has exactly the keys and shapes of
    the JAX variables (eval_shape: nothing is compiled)."""
    jcfg = getattr(jax_pose, f"yolo_nas_pose_{variant}_config")()
    pcfg = getattr(yolo_nas_pose, f"yolo_nas_pose_{variant}_config")()
    assert _config_dict(jcfg) == _config_dict(pcfg)
    name = f"yolo_nas_pose_{variant}_arch_params"
    j_arch = jax_pose.yolo_nas_pose_config_from_arch_params(jax_config.load_arch_params(name))
    p_arch = yolo_nas_pose.yolo_nas_pose_config_from_arch_params(config.load_arch_params(name))
    assert _config_dict(j_arch) == _config_dict(p_arch)
    assert p_arch.heads == pcfg.heads and p_arch.num_joints == 17
    shapes = jax.eval_shape(jax_pose.YoloNASPose(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    expected = {k: tuple(t.shape) for k, t in variables_from_jax_to_torch(zeros, rules=YOLO_NAS_POSE_RULES).items()}
    got = {k: tuple(t.shape) for k, t in yolo_nas_pose.YoloNASPose(pcfg).state_dict().items()}
    assert got == expected


def test_models_get_from_arch_params_builds_the_variant():
    arch = config.load_arch_params("yolo_nas_pose_n_arch_params")
    a = models.get("yolo_nas_pose_n", image_size=SIDE, device="cpu", arch_params=arch)
    b = models.get("yolo_nas_pose_n", image_size=SIDE, device="cpu")
    assert a.config == b.config and type(a).__name__ == "PoseEstimationModel"
    assert a.num_classes == 17 and len(a._class_names) == 17 and a._edge_links is not None
    for k, t in a.net.state_dict().items():
        assert torch.equal(t, b.net.state_dict()[k]), k


def test_keypoint_decode_offset_and_multiplier():
    """``(pose_reg * mult + anchor - offset) * stride``: the anchor's +0.5 is taken off only
    with ``compensate_grid_cell_offset`` (a half-stride error would pass a loose test)."""
    base = yolo_nas_pose.yolo_nas_pose_n_config()
    x = torch.rand(1, 3, SIDE, SIDE, generator=torch.Generator().manual_seed(0))
    outs = {}
    for comp in (True, False):
        cfg = dataclasses.replace(base, compensate_grid_cell_offset=comp, pose_offset_multiplier=2.0)
        gen = torch.Generator().manual_seed(1)
        net = yolo_nas_pose.YoloNASPose(cfg).reset_parameters(gen)
        _calibrate_batch_norm(net, gen, (2, 3, SIDE, SIDE))  # as models.get: unit-scale activations
        with torch.no_grad():
            outs[comp] = net(x)
    o = outs[True]
    b, a, j, _ = o.pred_pose_coords.shape
    raw = torch.cat([getattr(net.heads, f"head{i}")(f)[2].permute(0, 2, 3, 1).reshape(b, -1, j, 2)
                     for i, f in zip((1, 2, 3), net.neck(net.backbone(x)))], dim=1)
    want = (raw * 2.0 + o.anchor_points[None, :, None, :] - 0.5) * o.stride_tensor[None, :, None, :]
    torch.testing.assert_close(o.pred_pose_coords, want, atol=1e-4, rtol=0)
    shift = outs[False].pred_pose_coords - o.pred_pose_coords
    torch.testing.assert_close(shift, 0.5 * o.stride_tensor[None, :, None, :].expand_as(shift), atol=1e-4, rtol=0)
