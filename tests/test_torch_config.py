"""The port's recipe helpers against the JAX package's, on the CPU: ``load_arch_params``
on each copied YOLO-NAS arch_params file (and a YOLO-NAS built from it), ``HpmStruct``
and ``raise_if_unused_params`` (as ``tests/test_common.py`` holds the JAX ones)."""

import numpy as np
import pytest
import torch

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from test_torch_yolo_nas import jax_numpy_variables

torch.set_num_threads(2)


@pytest.mark.parametrize("variant", ["s", "m", "l"])
def test_load_arch_params_equals_jax(variant):
    name = f"yolo_nas_{variant}_arch_params"
    got = config.load_arch_params(name)
    assert got == jax_config.load_arch_params(name)
    over = {"bn_eps": 1e-4, "heads": {"NDFLHeads": {"num_classes": 7, "reg_max": 16, "heads_list": []}}}
    assert config.load_arch_params(name, overriding_params=over) == jax_config.load_arch_params(name, overriding_params=over)
    # the module-spec tree builds the variant's own network
    built = models.get(f"yolo_nas_{variant}", arch_params=got, device="cpu", image_size=64)
    assert built.config == models.get(f"yolo_nas_{variant}", device="cpu", image_size=64).config


def test_reshaped_arch_params_build_the_jax_network():
    """A reshaped tree (narrower stem and first head) gives the network the JAX package
    builds from it: its weights load into the port's, name for name and shape for shape,
    and the forwards agree."""
    ap = config.load_arch_params("yolo_nas_s_arch_params")
    ap["backbone"]["NStageBackbone"]["stem"]["YoloNASStem"]["out_channels"] = 32
    ap["heads"]["NDFLHeads"]["heads_list"][0]["YoloNASDFLHead"]["inter_channels"] = 64
    jm = jax_models.get("yolo_nas_s", num_classes=5, image_size=64, arch_params=ap)
    pm = models.get("yolo_nas_s", num_classes=5, image_size=64, arch_params=ap, device="cpu")
    stock = models.get("yolo_nas_s", num_classes=5, image_size=64, device="cpu")
    assert pm.net.backbone.stem.conv.branch_3x3.conv.weight.shape[0] == 32
    assert {k: v.shape for k, v in pm.net.state_dict().items()} != {k: v.shape for k, v in stock.net.state_dict().items()}
    v = jax_numpy_variables(jm)
    pm.net.load_state_dict(variables_from_jax_to_torch(v), strict=True)
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    import jax
    import jax.numpy as jnp

    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    ref = jm.apply(jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pm.net(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.pred_scores.numpy(), np.asarray(ref.pred_scores), atol=5e-4, rtol=0)


def test_hpm_struct():
    for module in (config, jax_config):
        h = module.HpmStruct(a=1, b=2)
        assert h.override(b=3, c=4) is h
        assert h.a == 1 and h.b == 3 and h.to_dict() == {"a": 1, "b": 3, "c": 4}
        assert "a" in h and "zz" not in h and h.get("zz", 7) == 7
        h.set_schema({"type": "object"})
        assert h.to_dict() == {"a": 1, "b": 3, "c": 4} and h.to_dict(include_schema=True)["_schema"] == {"type": "object"}
    assert repr(config.HpmStruct(a=1)) == repr(jax_config.HpmStruct(a=1))


def test_raise_if_unused_params():
    with pytest.raises(config.UnusedConfigParamError, match="unused"):
        with config.raise_if_unused_params({"used": 1, "unused": 2}) as cfg:
            _ = cfg["used"]
    with config.raise_if_unused_params({"a": 1, "b": {"c": 2}, "d": 3}) as cfg:
        _ = cfg["a"], cfg["b"]["c"], cfg.get("d"), cfg.get("missing")
    assert issubclass(config.UnusedConfigParamError, ValueError)
    with pytest.raises(KeyError):  # an exception inside passes through, unused keys or not
        with config.raise_if_unused_params({"x": 1}) as cfg:
            cfg["nope"]
    # the tracked keys are the JAX manager's
    for module in (config, jax_config):
        manager = module.raise_if_unused_params({"a": {"b": {"c": 1}}, "e": 2})
        with pytest.raises(module.UnusedConfigParamError, match="'e'"):
            with manager as cfg:
                _ = cfg["a"]["b"]["c"]
        assert manager._used == {"a", "a.b", "a.b.c"}
