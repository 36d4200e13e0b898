"""DDRNet and RegSeg48 of the PyTorch port against the JAX package's modules, on the same weights.

The JAX variables are drawn from a numpy seed over the JAX module's traced init and carried
into the port through ``conversion/from_jax.py`` (strict); the port's ``state_dict`` also
converts back into the JAX tree through the JAX package's own mappers (``ddrnet_key_mapper``,
``regseg_key_mapper``), so an original checkpoint's names are the port's. Sizes: DDRNet-39's
layout (two layer-3 repeats; DDRNet-23's is its one-repeat case, held in
``test_torch_seg_zoo_recipe.py``) at ``planes`` 8 / ``highres_planes`` 16 / ``head_planes`` 16 with
its aux head, at 96x160 (a multiple of 8 but not of 64: the 1/64 context map is 2x3, resized to
12x20 by non-integer ratios); RegSeg48 at its published widths (5 classes), 64x64, and for the train step its stages cut to their first
one, two and three blocks (every kind of block once). Every comparison is in fp64 on both sides at
``rtol = atol = 1e-9`` (``tests/torch_seg_parity.py``): the eval-mode logits, the train-mode
outputs (DDRNet's ``(main, aux)``), and one SGD step of the summed cross-entropy of the outputs
(weights, BN running means, BN running variances mapped from flax's biased update by
``n / (n - 1)``). The registry builds every name at its JAX parameter count.
"""

import dataclasses

import numpy as np
import pytest
import torch

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.models.segmentation import ddrnet as jax_ddrnet
from super_gradients_tpu.models.segmentation import regseg as jax_regseg
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import DDRNET_RULES, REGSEG_RULES
from super_gradients_tpu_torch.models.segmentation import ddrnet, regseg
from super_gradients_tpu_torch.models.sg_model import SegmentationModel
from torch_jax_init import param_count
from torch_seg_parity import check_step, check_torch_keys_reach_jax, run_case, tree_size

torch.set_num_threads(2)

NARROW = {"planes": 8, "highres_planes": 16, "head_planes": 16}
DDRNET39_NARROW = dict(num_classes=5, layers=(3, 4, 3, 3, 1, 3, 3, 1), layer3_repeats=2, use_aux_heads=True, **NARROW)


def _ddrnet39():
    return (jax_ddrnet.DDRNet(jax_ddrnet.DDRNetCfg(**DDRNET39_NARROW)),
            ddrnet.DDRNet(ddrnet.DDRNetCfg(**DDRNET39_NARROW)))


def _regseg48():
    kw = dict(num_classes=5, input_hw=(64, 64))
    return jax_models.get_architecture("regseg48")(**kw).module, models.get("regseg48", device="cpu", **kw).net


# RegSeg48's stages cut to the first one, two and three blocks: each kind of block once (stride 2
# with the pooled shortcut, stride 1 with the identity, one dilation, the split (1, 2)), under
# RegSeg48's own block names
REGSEG_CUT = tuple(stage[:n] for stage, n in zip(regseg.REGSEG48_STAGES, (1, 2, 3)))


def _regseg_cut():
    return (jax_regseg.RegSeg(jax_regseg.RegSegCfg(num_classes=5, stages=REGSEG_CUT)),
            regseg.RegSeg(regseg.RegSegCfg(num_classes=5, stages=REGSEG_CUT)))


CASES = {  # name: (builder of (JAX module, port net), port rules, JAX mapper, input size)
    "ddrnet39_narrow_aux": (_ddrnet39, DDRNET_RULES, tc.ddrnet_key_mapper(), (96, 160)),
    "regseg48": (_regseg48, REGSEG_RULES, tc.regseg_key_mapper(), (64, 64)),
    "regseg48_cut": (_regseg_cut, REGSEG_RULES, tc.regseg_key_mapper(), (64, 64)),
}
EVAL_CASES = ["ddrnet39_narrow_aux", "regseg48"]
TRAIN_CASES = ["ddrnet39_narrow_aux", "regseg48_cut"]


@pytest.fixture(scope="module")
def runs():
    return {}


@pytest.fixture
def run(request, runs):
    """A case's JAX module, variables and port net, and both packages' eval outputs and step,
    computed once in the module."""
    case = request.param
    if case not in runs:
        build, rules, _, hw = CASES[case]
        runs[case] = run_case(case, build, rules, hw, case in EVAL_CASES, case in TRAIN_CASES)
    return runs[case]


@pytest.mark.parametrize("run", list(CASES), indirect=True)
def test_weights_convert_both_ways(run):
    """The JAX tree loads strictly into the port net, and the port's ``state_dict`` converts
    strictly into the JAX tree through the JAX package's mapper; the parameter counts agree."""
    check_torch_keys_reach_jax(run.net, run.variables, CASES[run.case][2])
    assert tree_size(run.variables["params"]) == sum(p.numel() for p in run.net.parameters())


@pytest.mark.parametrize("run", EVAL_CASES, indirect=True)
def test_forward_eval_matches_jax_in_fp64(run):
    refs, got = run.eval
    assert len(refs) == len(got) == 1 and got[0].shape == (2, *CASES[run.case][3], 5)
    np.testing.assert_allclose(got[0], refs[0], rtol=1e-9, atol=1e-9)
    assert np.abs(refs[0]).max() > 0.1


@pytest.mark.parametrize("run", TRAIN_CASES, indirect=True)
def test_forward_train_mode_matches_jax_in_fp64(run):
    """Train-mode outputs through batch-statistics BN: DDRNet's ``(main, aux)``, RegSeg's map."""
    (j_outs, _, _), (p_outs, _, _, _) = run.step
    assert len(p_outs) == len(j_outs) == (2 if "aux" in run.case else 1)
    for got, ref in zip(p_outs, j_outs):
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("run", TRAIN_CASES, indirect=True)
def test_one_sgd_step_matches_jax_in_fp64(run):
    """The weights and every BN buffer after one step; RegSeg's ``bn2`` at momentum 0.01."""
    sizes = check_step(*run.step, CASES[run.case][1])
    momenta = {m for _, m in sizes.values()}
    assert momenta == ({0.1, 0.01} if run.case.startswith("regseg") else {0.1})


def test_eval_returns_main_and_train_adds_the_aux_head():
    """With ``use_aux_heads`` the train-mode output is ``(main, aux)``; eval mode returns the
    main map alone and never runs ``seghead_extra``; without it there is no aux head."""
    net = models.get("custom_ddrnet_23", num_classes=3, arch_params=dict(NARROW, use_aux_heads=True),
                     input_hw=(64, 64), device="cpu").net.eval()
    ran = []
    net.seghead_extra.register_forward_hook(lambda *a: ran.append(1))
    with torch.no_grad():
        out = net(torch.randn(1, 3, 64, 64))
    assert out.shape == (1, 3, 64, 64) and ran == []
    train_out = net.train()(torch.randn(2, 3, 64, 64))
    assert len(train_out) == 2 and all(o.shape == (2, 3, 64, 64) for o in train_out) and ran == [1]
    plain = models.get("custom_ddrnet_23", num_classes=3, arch_params=NARROW, input_hw=(64, 64), device="cpu").net
    assert not hasattr(plain, "seghead_extra") and plain.train()(torch.randn(2, 3, 64, 64)).shape == (2, 3, 64, 64)


def test_dappm_pooling_matches_jax():
    """A DAPPM branch of stride s: a zero pad of s, then ``avg_pool(k, s)`` counting the padding,
    and the global mean at stride 0, at map sizes that do and do not divide."""
    import jax.numpy as jnp
    import flax.linen as fnn

    for hw in ((2, 3), (5, 7), (8, 8)):
        x = np.random.RandomState(hw[1]).randn(2, *hw, 4).astype(np.float32)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        for k, s in ((5, 2), (9, 4), (17, 8)):
            ref = fnn.avg_pool(jnp.pad(jnp.asarray(x), ((0, 0), (s, s), (s, s), (0, 0))), (k, k), strides=(s, s),
                               count_include_pad=True)
            branch = ddrnet.DAPPMBranch(k, s, 4, 4, first=True)
            got = branch.down_scale[0](xt)
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        mean = ddrnet.DAPPMBranch(0, 0, 4, 4, first=True).down_scale[0](xt)
        np.testing.assert_allclose(mean.permute(0, 2, 3, 1).numpy(), x.mean(axis=(1, 2), keepdims=True), rtol=1e-6,
                                   atol=1e-6)


ZOO = {"ddrnet_23": 20_148_947, "ddrnet_23_slim": 5_695_987, "ddrnet_39": 32_360_275, "custom_ddrnet_23": 20_148_947,
       "regseg48": 3_334_983}


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_registers_the_family(name):
    """Every name builds a 19-class ``SegmentationModel`` at 512x1024 with the Cityscapes class
    names and the JAX model's parameter count; the GPU default raises without a GPU."""
    model = models.get(name, device="cpu")
    jspec = jax_models.get_architecture(name)(num_classes=None, arch_params={})
    assert sum(p.numel() for p in model.net.parameters()) == ZOO[name] == param_count(jspec.module, (1, *jspec.init_hw, 3), train=False)
    assert isinstance(model, SegmentationModel) and model.num_classes == jspec.num_classes == 19
    assert tuple(jspec.input_hw) == (512, 1024) and model._class_names == jspec.class_names
    out, _ = model._processing.preprocess_image(np.zeros((40, 60, 3), np.uint8))
    assert out.shape == (512, 1024, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.get(name)


def test_custom_ddrnet_reads_its_widths():
    net = models.get("custom_ddrnet_23", num_classes=4, arch_params=dict(NARROW, num_classes=9), device="cpu").net
    cfg = dataclasses.asdict(net.cfg)
    assert {k: cfg[k] for k in NARROW} == NARROW and cfg["num_classes"] == 4
    assert net.final_layer.conv2.out_channels == 4 and net._backbone.stem[0][0].out_channels == 8
