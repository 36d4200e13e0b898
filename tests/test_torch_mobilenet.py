"""MobileNet V1 / V2 / V3 of the PyTorch port against the JAX package's, on the same weights.

The port model is built by ``models.get(..., device="cpu")`` (seeded random weights, BN
statistics calibrated on noise) and its ``state_dict`` goes into the JAX model through the
JAX package's converter (``convert_state_dict`` with the MobileNet key mappers); the other
direction, ``conversion/from_jax.py``'s ``MOBILENET_V{1,2,3}_RULES``, must load the JAX
model's own initial variables strictly. Every registered MobileNet is checked name for name
and shape for shape against the JAX module at its full width (``jax.eval_shape``, no
compile), widths 0.35-1.4 included: V3's hidden widths come from a float expand ratio.

Tolerances, on the CPU at 64x64 (one cut-down model a family: V2 at width 0.5, V3-large
at 0.5, V3-small at 0.75, V1 at full width): eval-mode logits at ``atol=1e-4, rtol=1e-4``
(other summation orders; logits O(1-10)); the train-mode forward (batch-statistics BN,
dropout 0 on both sides) and the updated BN means in fp64 (``jax.enable_x64``) at
``rtol=1e-9``; ``predict()`` top-5 labels equal and probabilities within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.common.registry import ARCHITECTURES
from super_gradients_tpu_torch.conversion import from_jax
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.models.classification.mobilenet import _make_divisible
from super_gradients_tpu_torch.models.segmentation.stdc import SeededDropout
from torch_jax_init import FP64_COMPILE, jax_model

torch.set_num_threads(2)
SIDE = 64
CASES = {  # name: (models.get kwargs, port rules, JAX key mapper)
    "mobilenet_v1": (dict(num_classes=10), from_jax.MOBILENET_V1_RULES, tc.mobilenet_v1_key_mapper),
    "mobilenet_v2": (dict(num_classes=10, arch_params={"width_mult": 0.5}), from_jax.MOBILENET_V2_RULES,
                     tc.mobilenet_v2_key_mapper),
    "mobilenet_v3_large": (dict(num_classes=10, arch_params={"width_mult": 0.5}), from_jax.MOBILENET_V3_RULES,
                           tc.mobilenet_v3_key_mapper),
    "mobilenet_v3_small": (dict(num_classes=10, arch_params={"width_mult": 0.75}), from_jax.MOBILENET_V3_RULES,
                           tc.mobilenet_v3_key_mapper),
}


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def carried_pair(name, kw, mapper):
    """(JAX model, port model on the CPU) carrying the port model's weights."""
    pm = models.get(name, device="cpu", **kw)
    jm = jax_model(name, **kw)
    sd = {k: v.numpy() for k, v in pm.net.state_dict().items()}
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, tc.convert_state_dict(sd, jm.variables, mapper())))
    return jm, pm


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    kw, rules, mapper = CASES[request.param]
    jm, pm = carried_pair(request.param, kw, mapper)
    return request.param, jm, pm


def test_weights_carry_both_ways(pair):
    """The JAX tree of the port's weights converts back bit for bit, every tensor of the port
    net and of the JAX tree named, and loads strictly into a fresh port net."""
    name, jm, pm = pair
    kw, rules, _ = CASES[name]
    back = variables_from_jax_to_torch(numpy_tree(jm.variables), rules)
    sd = pm.net.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    models.get(name, device="cpu", seed=1, **kw).net.load_state_dict(back, strict=True)
    assert pm.num_params() == jm.num_params()


def test_forward_eval_matches_jax(pair):
    name, jm, pm = pair
    x = np.random.RandomState(1).randn(3, SIDE, SIDE, 3).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(jm.module.apply, train=False))(jm.variables, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == ref.shape == (3, 10) and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_forward_train_mode_matches_jax_in_fp64(pair):
    """Batch-statistics BN (dropout 0 on both sides): logits and running means in fp64."""
    name, jm, pm = pair
    kw, rules, _ = CASES[name]
    module = jm.module.clone(dropout=0.0) if hasattr(jm.module, "dropout") else jm.module
    x = np.random.RandomState(2).randn(2, SIDE, SIDE, 3)
    v0 = numpy_tree(jm.variables)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v0)
        apply = functools.partial(module.apply, train=True, mutable=["batch_stats"])
        out, mutated = jax.jit(apply, compiler_options=FP64_COMPILE)(v64, jnp.asarray(x))
        ref = np.asarray(out)
        new_stats = numpy_tree(mutated["batch_stats"])
    net = models.get(name, device="cpu", **kw).net
    net.load_state_dict(pm.net.state_dict())
    for m in net.modules():
        if isinstance(m, SeededDropout):
            m.p = 0.0
    net = net.double().train()
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
    jax_sd = variables_from_jax_to_torch({"params": v0["params"], "batch_stats": new_stats}, rules)
    means = [k for k in jax_sd if k.endswith("running_mean")]
    assert len(means) == sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    for key in means:
        torch.testing.assert_close(net.state_dict()[key], jax_sd[key].double(), rtol=1e-9, atol=1e-12)


FULL_WIDTH = {  # every registered MobileNet, at full width and at the widths where rounding bites
    "mobilenet_v1": {},
    "mobilenet_v2": {},
    "mobile_net_v2_135": {},
    "custom_mobilenet_v2": {"width_mult": 1.4},
    "mobilenet_v3_large": {},
    "mobilenet_v3_small": {},
    "mobilenet_v3_custom": {"width_mult": 0.35, "mode": "small"},
    "mobilenet_v3_custom-1.25": {"width_mult": 1.25},
}
RULES_OF = {"mobilenet_v1": from_jax.MOBILENET_V1_RULES, "mobile_net_v2_135": from_jax.MOBILENET_V2_RULES,
            "mobilenet_v2": from_jax.MOBILENET_V2_RULES, "custom_mobilenet_v2": from_jax.MOBILENET_V2_RULES}


@pytest.mark.parametrize("case", sorted(FULL_WIDTH))
def test_every_registered_mobilenet_has_the_jax_tensors(case):
    """Names and shapes of every tensor equal to the JAX module's, translated by the port's
    rules, at the registered sizes (1000 classes, 224 px; V1 at 64)."""
    name = case.split("-")[0]
    ap = FULL_WIDTH[case]
    spec = jax_models.model_factory.get_architecture(name)(arch_params=ap)
    hw = spec.input_hw
    shapes = jax.eval_shape(functools.partial(spec.module.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 3)))
    rules = RULES_OF.get(name, from_jax.MOBILENET_V3_RULES)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    expected = {k: tuple(v.shape) for k, v in variables_from_jax_to_torch(zeros, rules).items()}
    got = {k: tuple(v.shape) for k, v in ARCHITECTURES[name](arch_params=ap).net.state_dict().items()}
    assert got == expected


def test_make_divisible_and_v3_float_ratio_match_jax():
    from super_gradients_tpu.models.classification.mobilenet import _make_divisible as jax_make_divisible

    for v in np.linspace(0.5, 2000.0, 4001):
        assert _make_divisible(float(v)) == jax_make_divisible(float(v))
    for cin, exp in ((80, 184), (24, 88), (40, 120), (48, 144)):
        for wm in (0.35, 0.75, 1.25):
            e = _make_divisible(exp * wm)
            assert _make_divisible(cin * (e / cin)) == jax_make_divisible(cin * (e / cin))


def test_predict_matches_jax():
    """``predict()`` of two images of other sizes through the ImageNet processing: top-5
    labels equal, probabilities within 1e-5 (V3-small at 0.75, 1000 classes)."""
    kw = dict(arch_params={"width_mult": 0.75})
    jm, pm = carried_pair("mobilenet_v3_small", kw, tc.mobilenet_v3_key_mapper)
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 256, (200, 260, 3), dtype=np.uint8), rng.randint(0, 256, (240, 180, 3), dtype=np.uint8)]
    got, ref = pm.predict(images, batch_size=2), jm.predict(images, batch_size=2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.labels, np.asarray(r.labels))
        np.testing.assert_allclose(g.confidence, np.asarray(r.confidence), atol=1e-5)
