"""The custom and variant registry names of the ResNet and STDC families
(``custom_resnet`` / ``custom_resnet50``, ``resnet50_3343``, ``custom_resnet_cifar`` /
``custom_resnet50_cifar``, ``stdc_custom_cls``, ``stdc_custom``), against the JAX package's.

Each is built by ``models.get`` in both packages with the same ``arch_params`` (narrow widths
and short stages where the builder takes them), the port's weights carried into JAX by the
JAX converter; the eval forward at a small input agrees within ``atol=1e-4, rtol=1e-4``
(logits) or, for the segmentation map, within twice JAX's distance to an fp64 run of the
port (the random-init seg logits amplify fp32 rounding). The
aliases build the same network as their names.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu_torch import models
from torch_jax_init import jax_model

torch.set_num_threads(2)

CASES = {  # name: (models.get kwargs, input HW, JAX key mapper)
    "custom_resnet": (dict(num_classes=5, arch_params={"structure": [1, 1, 1, 1], "block": "basic",
                                                      "width_mult": 0.25}), (48, 48), tc.resnet_key_mapper),
    "resnet50_3343": (dict(num_classes=5, arch_params={"width_mult": 0.25}), (48, 48), tc.resnet_key_mapper),
    "custom_resnet_cifar": (dict(num_classes=5, arch_params={"structure": [1, 1, 1, 1]}), (32, 32),
                            tc.resnet_key_mapper),
    "stdc_custom_cls": (dict(num_classes=5), (64, 64), tc.stdc_cls_key_mapper),
    "stdc_custom": (dict(num_classes=4, arch_params={"backbone": "stdc2", "use_aux_heads": False},
                         input_hw=(64, 128)), (64, 128), tc.stdc_key_mapper),
}
ALIASES = {"custom_resnet50": "custom_resnet", "custom_resnet50_cifar": "custom_resnet_cifar",
           "stdc_custom_cls": "stdc2_classification"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    kw, hw, mapper = CASES[name]
    pm = models.get(name, device="cpu", **kw)
    jm = jax_model(name, **kw)
    sd = {k: v.numpy() for k, v in pm.net.state_dict().items()}
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, tc.convert_state_dict(sd, jm.variables, mapper())))
    assert pm.num_params() == jm.num_params() and pm.num_classes == jm.num_classes
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(jm.module.apply, train=False))(jm.variables, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = pm.net.eval()(xt).numpy()
    if name != "stdc_custom":
        assert got.shape == ref.shape == (2, kw["num_classes"])
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
        return
    ref = ref.transpose(0, 3, 1, 2)
    with torch.no_grad():
        ref64 = pm.net.double()(xt.double()).numpy()
    assert got.shape == ref.shape == (2, 4, *hw)
    e_port, e_jax = np.abs(got - ref64).max(), np.abs(ref - ref64).max()
    assert e_port <= 2 * e_jax + 1e-6, (e_port, e_jax)


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_aliases_build_the_same_network(alias):
    a = models.get(alias, device="cpu", num_classes=5).net.state_dict()
    b = models.get(ALIASES[alias], device="cpu", num_classes=5).net.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
