"""STDC and PP-LiteSeg of the PyTorch port against the JAX package's, on the same weights.

The port model is built by ``models.get(..., device="cpu")`` (seeded random weights, BN
statistics calibrated on noise at 128x128) and its ``state_dict`` goes into the JAX model
through the JAX package's own converter (``convert_state_dict`` with ``stdc_key_mapper``,
``ppliteseg_key_mapper`` or ``stdc_cls_key_mapper``). The other direction,
``conversion/from_jax.py``, must give back the same tensors bit for bit and load the JAX
model's own initial parameters strictly.

Tolerances, on the CPU, at the published widths (19 classes cut to 5): the eval-mode logits
are held within twice JAX's distance (max abs) to an fp64 run of the port, the bound that
held at every size; ``atol=rtol=1e-4`` held for STDC classification (asserted) and for the
segmentation models at 64x64 but not at every size (PP-LiteSeg at 128x256, logits ~90:
JAX itself is 2.2e-3 from fp64). The BN statistics are set on a standard-normal batch (the
test inputs' law): with ``models.get``'s calibration on uniform noise at 128x128 the random
logits on these inputs reach 1e3-1e4, where fp32 rounding swamps any comparison. That
forward runs torch's own CPU convolution, not oneDNN's: oneDNN's fp32 convolutions on an
AVX-512 CPU land 3-6x further from fp64 than XLA's on such ill-conditioned logits (stdc1_seg at
96x96: 0.066 against 0.0093), torch's own within 1.3x; the card runs cuDNN in either case.
The input sizes reach the three forms of PP-LiteSeg's pooling: 64x64 and 64x128 (a 2x2 / 2x4 stride-32 map: pool 4 falls
back to the antialiased resize), 96x96 (3x3: pools 2 and 4 fall back) and 128x256 (4x8:
every pool divides). The train-mode forward (dropout 0, batch-statistics BN) is held in
fp64 (``jax.enable_x64``) at ``rtol=1e-9``, with the running variances mapped from flax's
biased update to torch's unbiased one by ``c = n / (n - 1)``.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.models.segmentation import ppliteseg as jax_pp
from super_gradients_tpu.models.segmentation import stdc as jax_stdc
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import (
    PPLITESEG_RULES,
    STDC_CLS_RULES,
    STDC_RULES,
    variables_from_jax_to_torch,
)
from super_gradients_tpu_torch.models.segmentation import ppliteseg, stdc
from super_gradients_tpu_torch.models.sg_model import ClassificationModel, SegmentationModel
from torch_jax_init import FP64_COMPILE, flax_like_variables, jax_model, param_count

torch.set_num_threads(2)

MAPPERS = {"stdc": (tc.stdc_key_mapper, STDC_RULES), "pp_lite": (tc.ppliteseg_key_mapper, PPLITESEG_RULES),
           "classification": (tc.stdc_cls_key_mapper, STDC_CLS_RULES)}


def _family(name):
    return "classification" if "classification" in name else ("pp_lite" if name.startswith("pp_lite") else "stdc")


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def calibrate_on(net, x):
    """Each BN's running statistics from one eval-mode forward of ``x`` (as ``models.get``
    calibrates on noise), so that eval-mode activations are unit scale on such inputs."""

    def set_stats(bn, inputs):
        bn.running_mean.copy_(inputs[0].mean(dim=(0, 2, 3)))
        bn.running_var.copy_(inputs[0].var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        net.eval()(x)
    for h in hooks:
        h.remove()


def carried_pair(name, **kw):
    """(JAX model, port model on the CPU, the JAX model's initial variables: flax's default
    initializers over its traced init, no init compiled) with the JAX model carrying the port
    model's weights, its BN statistics calibrated on a standard-normal batch at 96x96 (the test
    inputs' law)."""
    pm = models.get(name, device="cpu", **kw)
    calibrate_on(pm.net, torch.randn((4, 3, 96, 96), generator=torch.Generator().manual_seed(0)))
    jm = jax_model(name, **kw)
    initial = _numpy(jm.variables)
    sd = {k: v.numpy() for k, v in pm.net.state_dict().items()}
    mapper, _ = MAPPERS[_family(name)]
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, tc.convert_state_dict(sd, jm.variables, mapper())))
    return jm, pm, initial


def jax_param_count(name):
    """The parameter count of the JAX zoo's model from its traced init (nothing compiled)."""
    spec = jax_models.get_architecture(name)(num_classes=None, arch_params={})
    return param_count(spec.module, (1, *(spec.init_hw or spec.input_hw), 3), train=False)


SEG_CASES = {  # name: models.get kwargs
    "stdc1_seg": dict(num_classes=5, input_hw=(64, 64)),
    "stdc2_seg": dict(num_classes=5, input_hw=(64, 64)),
    "pp_lite_t_seg": dict(num_classes=5, input_hw=(64, 64)),
    "pp_lite_b_seg": dict(num_classes=5, input_hw=(64, 64)),
    "pp_lite_t_seg_aux": dict(num_classes=5, input_hw=(64, 64), arch_params={"use_aux_heads": True}),
    "stdc1_classification": dict(num_classes=5),
}


def _name(case):
    return case.replace("_aux", "")


@pytest.fixture(scope="module", params=list(SEG_CASES))
def pair(request):
    jm, pm, initial = carried_pair(_name(request.param), **SEG_CASES[request.param])
    return request.param, jm, pm, initial


def test_weights_carry_both_ways(pair):
    """JAX's tree of the port's weights converts back to the same tensors, bit for bit,
    and a JAX model's initial parameters (flax's default initializers over its traced init)
    load strictly into a fresh port net, with the same parameter count on both sides."""
    case, jm, pm, initial = pair
    _, rules = MAPPERS[_family(case)]
    back = variables_from_jax_to_torch(_numpy(jm.variables), rules)
    sd = pm.net.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    net = models.get(_name(case), device="cpu", **SEG_CASES[case]).net
    net.load_state_dict(variables_from_jax_to_torch(initial, rules), strict=True)
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(initial["params"]))
    assert n_jax == sum(p.numel() for p in net.parameters())


def _eval_sizes(case):
    return [(64, 64), (96, 96), (128, 256)] if "classification" not in case else [(64, 64)]


def test_forward_eval_matches_jax(pair):
    """The port's fp32 logits within twice JAX's distance to an fp64 run of the port; STDC
    classification's also at ``atol=rtol=1e-4``."""
    case, jm, pm, _ = pair
    net64 = copy.deepcopy(pm.net).double().eval()
    forward = jax.jit(lambda v, x: jm.module.apply(v, x, train=False))
    for hw in _eval_sizes(case):
        x = np.random.RandomState(hw[0]).randn(2, *hw, 3).astype(np.float32)
        ref = np.asarray(forward(jm.variables, jnp.asarray(x)))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
            got, ref64 = pm.net.eval()(xt), net64(xt.double())
        to_nhwc = (lambda t: t.permute(0, 2, 3, 1).numpy()) if got.dim() == 4 else (lambda t: t.numpy())
        got, ref64 = to_nhwc(got), to_nhwc(ref64)
        assert got.shape == ref.shape and np.abs(ref).max() > 0.1, (hw, np.abs(ref).max())
        e_port, e_jax = np.abs(got - ref64).max(), np.abs(ref - ref64).max()
        assert e_port <= 2 * e_jax, (hw, e_port, e_jax)
        if "classification" in case:
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4, err_msg=str(hw))


def _train_forward(net, x):
    """The outputs of ``net(x)`` and each BN's number of inputs per channel in that call."""
    sizes = {}
    hooks = [m.register_forward_pre_hook(lambda mod, inp, n=n: sizes.__setitem__(n, inp[0].numel() // inp[0].shape[1]))
             for n, m in net.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        out = net(x)
    for h in hooks:
        h.remove()
    return out, sizes


TRAIN_CASES = {  # JAX module, port module (dropout 0), rules, input size
    "stdc1_seg": (lambda: jax_stdc.STDCSegmentation(jax_stdc.STDCSegCfg(num_classes=4, dropout=0.0)),
                  lambda: stdc.STDCSegmentation(stdc.STDCSegCfg(num_classes=4, dropout=0.0)), STDC_RULES, (64, 128)),
    "pp_lite_t_seg_aux": (
        lambda: jax_pp.PPLiteSeg(dataclasses.replace(jax_pp.PP_LITE_T_CFG, num_classes=4, use_aux_heads=True)),
        lambda: ppliteseg.PPLiteSeg(dataclasses.replace(ppliteseg.PP_LITE_T_CFG, num_classes=4, use_aux_heads=True)),
        PPLITESEG_RULES, (96, 96)),
    "pp_lite_b_seg": (
        lambda: jax_pp.PPLiteSeg(dataclasses.replace(jax_pp.PP_LITE_B_CFG, num_classes=4)),
        lambda: ppliteseg.PPLiteSeg(dataclasses.replace(ppliteseg.PP_LITE_B_CFG, num_classes=4)),
        PPLITESEG_RULES, (64, 64)),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_forward_train_mode_matches_jax_in_fp64(case):
    """Every train-mode output (STDC's four, PP-LiteSeg's main and three aux maps) and the
    updated BN buffers, through batch-statistics BN, against JAX under ``enable_x64``."""
    make_jax, make_port, rules, hw = TRAIN_CASES[case]
    rng = np.random.RandomState(3)
    x = rng.randn(2, *hw, 3)
    jmod = make_jax()
    v0 = flax_like_variables(jmod, (1, *hw, 3), seed=0, train=False)
    for path, leaf in jax.tree_util.tree_flatten_with_path(v0["batch_stats"])[0]:
        leaf[...] = rng.rand(*leaf.shape) + (0.5 if path[-1].key == "var" else -0.5)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v0)
        out, mutated = jax.jit(lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]),
                               compiler_options=FP64_COMPILE)(v64, jnp.asarray(x))
        refs = [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]
        new_stats = _numpy(mutated["batch_stats"])
    net = make_port()
    net.load_state_dict(variables_from_jax_to_torch(v0, rules), strict=True)
    net = net.double()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    got, sizes = _train_forward(net.train(), xt)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(refs) == (4 if case != "pp_lite_b_seg" else 1)
    for g, r in zip(got, refs):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r, rtol=1e-9, atol=1e-9)
    jax_sd = variables_from_jax_to_torch({"params": v0["params"], "batch_stats": new_stats}, rules)
    after = net.state_dict()
    checked = 0
    for key in (k for k in after if k.endswith("running_var")):
        prefix = key[: -len(".running_var")]
        c = sizes[prefix] / (sizes[prefix] - 1)
        old = before[key]
        torch.testing.assert_close(after[key], 0.9 * old + c * (jax_sd[key].double() - 0.9 * old), rtol=1e-9,
                                   atol=1e-12)
        torch.testing.assert_close(after[prefix + ".running_mean"], jax_sd[prefix + ".running_mean"].double(),
                                   rtol=1e-9, atol=1e-12)
        checked += 1
    assert checked == len(sizes) == sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())


def test_eval_mode_skips_the_aux_heads():
    """In eval mode STDC returns the main map alone and never runs its aux and detail heads."""
    net = models.get("stdc1_seg", num_classes=3, input_hw=(64, 64), device="cpu").net.eval()
    ran = []
    for name in ("aux_head_s16", "aux_head_s32", "detail_head8"):
        getattr(net, name).register_forward_hook(lambda *a, n=name: ran.append(n))
    with torch.no_grad():
        out = net(torch.randn(1, 3, 64, 64))
    assert out.shape == (1, 3, 64, 64) and ran == []
    net.train()
    assert len(net(torch.randn(2, 3, 64, 64))) == 4 and sorted(ran) == ["aux_head_s16", "aux_head_s32", "detail_head8"]


def test_dropout_acts_in_train_mode_only():
    """The seg heads' dropout (0.2) draws its masks from a seeded generator: two train-mode
    calls differ, a fresh model repeats them, and eval mode has no dropout."""
    head = stdc.SegmentationHead(8, 16, 3, dropout=0.2)
    stdc.reset_segmentation_parameters(head, torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 6, 6)
    head.eval()
    with torch.no_grad():
        e1, e2 = head(x), head(x)
        head.train()
        t1, t2 = head(x), head(x)
    assert torch.equal(e1, e2) and not torch.equal(t1, t2) and not torch.equal(t1, e1)
    drop = head.seg_head[1]
    assert drop.p == 0.2 and drop.calls == 2
    hidden = head.seg_head[0](x)
    keep = (torch.rand(hidden.shape, generator=torch.Generator().manual_seed(0)) >= 0.2)
    ref = head.seg_head[2](hidden * keep / 0.8)
    torch.testing.assert_close(t1, ref, rtol=0, atol=0)
    zero = stdc.SeededDropout(0.0).train()
    assert zero(x) is x


def test_upsample_modes_match_jax():
    """``nearest`` is torch's nearest-exact (jax.image.resize's), also at a non-integer
    factor; ``bilinear_ac`` the align-corners grid; ``bilinear`` the half-pixel one."""
    x = np.random.RandomState(4).randn(2, 5, 7, 3).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for method in ("nearest", "bilinear_ac", "bilinear"):
        for scale in (2, 8):
            ref = np.asarray(jax_stdc._upsample(jnp.asarray(x), scale, method))
            got = stdc.upsample(xt, scale, method).permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5, err_msg=f"{method} x{scale}")
    y = np.random.RandomState(5).randn(1, 13, 13, 2).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(y), (1, 50, 50, 2), method="nearest"))
    got = F.interpolate(torch.from_numpy(y).permute(0, 3, 1, 2), size=(50, 50), mode="nearest-exact")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("hw,out_size", [((2, 2), 4), ((3, 3), 2), ((3, 3), 4), ((5, 5), 4), ((6, 6), 4),
                                         ((4, 8), 2), ((4, 8), 4), ((6, 6), 1), ((2, 4), 4)])
def test_adaptive_avg_pool_matches_jax(hw, out_size):
    """The mean, the divisible ``avg_pool`` and the antialiased resize fallback; and SPPM's
    resize back to the map's size, which shrinks in the fallback case."""
    x = np.random.RandomState(6).randn(2, *hw, 3).astype(np.float32)
    ref = np.asarray(jax_pp._adaptive_avg_pool(jnp.asarray(x), out_size))
    pooled = ppliteseg.adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), out_size)
    np.testing.assert_allclose(pooled.permute(0, 2, 3, 1).numpy(), ref, atol=1e-6, rtol=1e-6)
    back = np.asarray(jax.image.resize(jnp.asarray(ref), (2, *hw, 3), method="bilinear"))
    got = ppliteseg.resize_linear(torch.from_numpy(ref).permute(0, 3, 1, 2), hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), back, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name,expected_params", [
    ("stdc1_seg", 9_310_176), ("stdc1_seg50", 9_310_176), ("stdc1_seg75", 9_310_176), ("stdc2_seg", 13_340_640),
    ("stdc2_seg50", 13_340_640), ("pp_lite_t_seg", 8_027_808), ("pp_lite_t_seg50", 8_027_808),
    ("pp_lite_b_seg", 12_234_240), ("pp_lite_b_seg75", 12_234_240), ("stdc1_classification", 8_441_504),
    ("stdc2_classification", 12_471_968)])
def test_zoo_registers_the_family(name, expected_params):
    """Every name builds the JAX spec's task model at its class count (19 Cityscapes
    classes / 1000) and processing, with the JAX model's parameter count; the GPU default
    raises without a GPU."""
    model = models.get(name, device="cpu")
    jspec = jax_models.get_architecture(name)(num_classes=None, arch_params={})
    assert sum(p.numel() for p in model.net.parameters()) == expected_params
    assert expected_params == jax_param_count(name)
    assert model.num_classes == jspec.num_classes and tuple(jspec.input_hw) == (
        (224, 224) if "classification" in name else (512, 1024))
    assert isinstance(model, ClassificationModel if "classification" in name else SegmentationModel)
    assert model._class_names == jspec.class_names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.get(name)


def test_arch_params_and_input_hw():
    """``use_aux_heads`` reaches both families (STDC on, PP-LiteSeg off by default);
    ``input_hw`` sets the processing's size."""
    assert not hasattr(models.get("pp_lite_t_seg", device="cpu").net, "aux_heads")
    assert len(models.get("pp_lite_t_seg", arch_params={"use_aux_heads": True}, device="cpu").net.aux_heads) == 3
    assert not hasattr(models.get("stdc1_seg", arch_params={"use_aux_heads": False}, device="cpu").net, "detail_head8")
    model = models.get("stdc1_seg", num_classes=3, input_hw=(96, 96), device="cpu")
    out, _ = model._processing.preprocess_image(np.zeros((50, 70, 3), np.uint8))
    assert out.shape == (96, 96, 3) and model._class_names is None
