"""The classification zoo's registry in the PyTorch port against the JAX package's.

Every one of the 55 names builds, and each one's parameter count and ``state_dict`` (names and
shapes, through ``conversion/from_jax.py``'s rules: ``state_dict_shapes_from_jax``, which allocates
nothing) equal the JAX spec's (``jax.eval_shape``, nothing compiled; a name whose JAX module equals
another's, field for field, reuses its trace).
Through ``models.get`` on the CPU (seeded init, BN calibration) at the registered size where that
is at most 300 px and 150 M parameters; the others (EfficientNet B4-B8 and L2, ViT-Huge,
BEiT-Large) through the registered function on ``torch.device("meta")``, which allocates nothing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.common.registry import ARCHITECTURES as JAX_ARCHITECTURES
from super_gradients_tpu.models.model_factory import get_architecture
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.common.registry import ARCHITECTURES
from super_gradients_tpu_torch.conversion import from_jax
from super_gradients_tpu_torch.conversion.from_jax import state_dict_shapes_from_jax, variables_from_jax_to_torch
from super_gradients_tpu_torch.models.classification.misc_models import VGG_CFGS

torch.set_num_threads(2)

RULES = {  # name prefix: the port's rules
    "efficientnet_": from_jax.EFFICIENTNET_RULES, "CustomizedEfficientnet": from_jax.EFFICIENTNET_RULES,
    "regnetY": from_jax.REGNET_RULES, "custom_regnet": from_jax.REGNET_RULES, "custom_anynet": from_jax.REGNET_RULES,
    "nas_regnet": from_jax.REGNET_RULES, "repvgg_": from_jax.REPVGG_RULES, "vit_": from_jax.VIT_RULES,
    "beit_": from_jax.BEIT_RULES, "densenet": from_jax.DENSENET_RULES, "custom_densenet": from_jax.DENSENET_RULES,
    "shufflenet_": from_jax.SHUFFLENET_RULES, "resnext": from_jax.RESNEXT_RULES, "dpn": from_jax.DPN_RULES,
    "pnasnet": from_jax.PNASNET_RULES, "darknet53": from_jax.DARKNET53_RULES,
    "csp_darknet53": from_jax.CSP_DARKNET53_RULES, "preact_": from_jax.PREACT_RULES, "senet": from_jax.SENET_RULES,
    "vgg16": from_jax.vgg_rules(VGG_CFGS["vgg16"]), "vgg19_bn": from_jax.vgg_rules(VGG_CFGS["vgg19"]),
    "lenet": (), "googlenet_v1": (),
}
NAMES = sorted(n for n in JAX_ARCHITECTURES if n.startswith(tuple(RULES)))
# names whose JAX module equals another's (asserted) share its trace
SHARES_A_SHAPE = {"custom_anynet": "custom_regnet", "nas_regnet": "custom_regnet",
                  "CustomizedEfficientnet": "efficientnet_b0", "repvgg_custom": "repvgg_a0",
                  "custom_densenet": "densenet121", "shufflenet_v2_custom5": "shufflenet_v2_x0_5"}


def _rules(name):
    return RULES[max((p for p in RULES if name.startswith(p)), key=len)]


@functools.lru_cache(maxsize=None)
def _jax_shapes(name):
    spec = get_architecture(name)(num_classes=None, arch_params={})
    shapes = jax.eval_shape(functools.partial(spec.module.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, *spec.input_hw, 3)))
    return spec.input_hw, shapes


def test_the_names_are_the_55_of_the_zoo():
    assert len(NAMES) == 55
    ported = set(ARCHITECTURES) & set(JAX_ARCHITECTURES)
    assert set(JAX_ARCHITECTURES) - ported == {"dekr_w32_no_dc", "dekr_custom", "pose_rescoring",
                                               "pose_rescoring_coco", "pose_rescoring_custom"}
    assert len(ported) == 130 and len(JAX_ARCHITECTURES) == 135


@pytest.mark.parametrize("name", NAMES)
def test_every_name_builds_at_the_jax_parameter_count(name):
    if name in SHARES_A_SHAPE:
        assert get_architecture(name)().module == get_architecture(SHARES_A_SHAPE[name])().module
    hw, shapes = _jax_shapes(SHARES_A_SHAPE.get(name, name))
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    if max(hw) <= 300 and jax_count <= 150e6:
        model = models.get(name, device="cpu")
        net = model.net
        assert all(bool(torch.isfinite(m.running_var).all()) for m in net.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
    else:
        with torch.device("meta"):
            spec = ARCHITECTURES[name](arch_params={})
        net = spec.net
        assert tuple(spec.input_hw) == tuple(hw)
    assert sum(p.numel() for p in net.parameters()) == jax_count
    expected = state_dict_shapes_from_jax(shapes, _rules(name))
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == expected


@pytest.mark.parametrize("name", ["regnetY200", "shufflenet_v2_x0_5"])
def test_shape_only_conversion_names_what_the_converter_makes(name):
    """``state_dict_shapes_from_jax`` (the test above's expectation, nothing allocated) gives the
    names and shapes ``variables_from_jax_to_torch`` makes of the same tree in zeros."""
    _, shapes = _jax_shapes(name)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    made = {k: tuple(v.shape) for k, v in variables_from_jax_to_torch(zeros, _rules(name)).items()}
    assert state_dict_shapes_from_jax(shapes, _rules(name)) == made


