"""``CustomizableDetector`` and its module registry of the port against the JAX package's.

The spec forms, the unknown-name error and the registered builders equal JAX's; a tiny
YOLO-NAS assembled from registered names (the JAX test's YAML-style spec) carries the JAX
variables (``_backbone`` / ``_neck`` / ``_heads`` there, ``backbone`` / ``neck`` / ``heads``
here, then ``YOLO_NAS_RULES``) and gives JAX's outputs at the YOLO-NAS parity tolerances
(scores ``atol=5e-4``, boxes ``atol=5e-2`` px); a CSPResNet + PP-YOLOE PAN + NDFL heads
detector builds from names with the widths passed from part to part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import assert_close
from super_gradients_tpu.common.registry import DETECTION_MODULES as JAX_DETECTION_MODULES
from super_gradients_tpu.models.detection import customizable_detector as jcd
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.models.detection import customizable_detector as pcd

torch.set_num_threads(2)

SPEC = dict(
    backbone={"NStageBackbone": {
        "stem_channels": 16,
        "stages": [{"out_channels": 32, "num_blocks": 1, "hidden_channels": 16},
                   {"out_channels": 64, "num_blocks": 1, "hidden_channels": 16},
                   {"out_channels": 128, "num_blocks": 1, "hidden_channels": 32},
                   {"out_channels": 256, "num_blocks": 1, "hidden_channels": 64}],
        "spp_channels": 256, "spp_k": [5, 9, 13]}},
    neck={"YoloNASPANNeckWithC2": {
        "neck1": {"out_channels": 64, "num_blocks": 1, "hidden_channels": 24},
        "neck2": {"out_channels": 32, "num_blocks": 1, "hidden_channels": 16},
        "neck3": {"out_channels": 64, "num_blocks": 1, "hidden_channels": 24},
        "neck4": {"out_channels": 128, "num_blocks": 1, "hidden_channels": 24}}},
    heads={"NDFLHeads": {"heads": [{"inter_channels": 32, "width_mult": 0.5, "stride": 8},
                                   {"inter_channels": 64, "width_mult": 0.5, "stride": 16},
                                   {"inter_channels": 128, "width_mult": 0.5, "stride": 32}],
                         "reg_max": 8}},
    num_classes=7,
)


@pytest.mark.parametrize("spec", ["NDFLHeads", ("NDFLHeads", {"num_classes": 3}), {"NDFLHeads": {"num_classes": 3}},
                                  {"NDFLHeads": None}])
def test_parse_module_spec_forms_match_jax(spec):
    assert pcd.parse_module_spec(spec) == jcd.parse_module_spec(spec)


def test_bad_specs_raise_as_jax():
    for bad, error in (({"A": {}, "B": {}}, ValueError), (3, TypeError)):
        with pytest.raises(error):
            jcd.parse_module_spec(bad)
        with pytest.raises(error):
            pcd.parse_module_spec(bad)
    with pytest.raises(KeyError, match="NStageBackbone"):
        pcd.build_detection_module("NoSuchModule")


def test_registered_builders_match_jax():
    assert sorted(pcd.DETECTION_MODULES) == sorted(JAX_DETECTION_MODULES) == [
        "CSPResNetBackbone", "NDFLHeads", "NStageBackbone", "PPYoloECSPPAN", "YoloNASPANNeckWithC2"]


def test_yaml_style_yolo_nas_matches_jax():
    det = jcd.CustomizableDetector(**SPEC)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    variables = jax.jit(det.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), jax.device_get(variables))
    for tree in v.values():
        for k in list(tree):
            tree[k.lstrip("_")] = tree.pop(k)
    for head in v["params"]["heads"].values():
        head["cls_pred"]["bias"][:] = 0.0
    ref = jax.jit(lambda v, x: det.apply(v, x, train=False))(
        jax.tree_util.tree_map(jnp.asarray, {c: {"_" + k: t for k, t in tree.items()} for c, tree in v.items()}),
        jnp.asarray(x))
    net = pcd.CustomizableDetector(**SPEC)
    net.load_state_dict(variables_from_jax_to_torch(v), strict=True)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    n_anchors = 8 * 8 + 4 * 4 + 2 * 2
    assert out.pred_scores.shape == (2, n_anchors, 7)
    assert_close(out.pred_scores.numpy(), np.asarray(ref.pred_scores), atol=5e-4, name="pred_scores")
    assert_close(out.pred_bboxes.numpy(), np.asarray(ref.pred_bboxes), atol=5e-2, rtol=1e-3, name="pred_bboxes")


def test_ppyoloe_parts_chain_their_widths():
    net = pcd.CustomizableDetector(
        backbone={"CSPResNetBackbone": {"width_mult": 0.25, "depth_mult": 0.33}},
        neck={"PPYoloECSPPAN": {"width_mult": 0.25, "depth_mult": 0.33}},
        heads={"NDFLHeads": {"heads": [{"inter_channels": 64, "width_mult": 0.5, "stride": 32},
                                       {"inter_channels": 32, "width_mult": 0.5, "stride": 16},
                                       {"inter_channels": 16, "width_mult": 0.5, "stride": 8}]}},
        num_classes=3)
    assert net.backbone.out_channels == (64, 128, 256) and net.neck.out_channels == (192, 96, 48)
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = net.eval()(torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(1)))
    assert out.pred_scores.shape == (1, 4 + 16 + 64, 3) and torch.isfinite(out.pred_bboxes).all()
