"""SegFormer, UNet and the UNet classifier of the PyTorch port against the JAX package's modules,
on the same weights.

As ``test_torch_ddrnet_regseg.py`` holds DDRNet: JAX variables drawn from a numpy seed, carried
into the port through ``conversion/from_jax.py`` (strict) and back through the JAX package's
``segformer_key_mapper`` / ``unet_key_mapper``; every comparison in fp64 at ``rtol = atol = 1e-9``
(``tests/torch_seg_parity.py``). Sizes:

- SegFormer with B0's heads and reduction ratios at widths 16-64 (two blocks in stage 1, decoder
  32; B0-B5 at their published widths are the registry's and the card's), eval and the train
  step at 40x56: the 1/4 map is 10x14, so each spatial-reduction conv (8, 4, 2) pads as XLA's
  ``SAME`` (3/3 and 1/1, then 1/2 and 0/1, then 0/1 and 0/0) and the head's resizes have
  non-integer ratios;
- UNet (``unet_custom``) at widths 8-16 in the classic layout (strides 1, 2, 2, 2, 2; repeats
  2, 2, 2, 1), 64x64, eval and the train step; the ``unet_default_arch_params`` layout (five
  stride-2 stages, skip projections at ``skip_expansion`` 0.5, a hidden head width and the x2
  final upsampling) at 64x64, eval; the classifier (``unet_custom_cls``) at widths 8-16, 32x32.

The registry builds every name at its JAX parameter count.
"""

import numpy as np
import pytest
import torch

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.models.segmentation import unet_segformer as jax_us
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import SEGFORMER_RULES, unet_classifier_rules, unet_rules
from super_gradients_tpu_torch.models.segmentation import unet_segformer as us
from super_gradients_tpu_torch.models.sg_model import ClassificationModel, SegmentationModel
from torch_jax_init import param_count
from torch_seg_parity import check_step, check_torch_keys_reach_jax, run_case, tree_size

torch.set_num_threads(2)

# B0's heads (1, 2, 5, 8) and reduction ratios at widths 16-64, two blocks in stage 1
NARROW_SEGFORMER = dict(num_classes=5, embed_dims=(16, 32, 40, 64), depths=(2, 1, 1, 1), decoder_dim=32)
UNET_CLASSIC = {"backbone_params": {"width_list": [8, 8, 16, 16, 16]}}
UNET_DEFAULT_LAYOUT = {"backbone_params": {"strides_list": [2, 2, 2, 2, 2], "width_list": [8, 8, 16, 16, 16],
                                           "num_blocks_list": [2, 3, 3, 2, 2]},
                       "decoder_params": {"skip_expansion": 0.5, "decoder_scale": 0.5, "up_block_repeat_list": [2, 2, 2, 1]},
                       "final_upsample_factor": 2, "head_hidden_channels": 12}
CLS_WIDTHS = {"widths": [8, 8, 16, 16, 16]}


def _zoo(name, hw=None, **kw):
    """The JAX zoo's module and the port's net of ``name`` at 5 classes."""
    kw = dict(kw, num_classes=5, **({"input_hw": hw} if hw else {}))
    return jax_models.get_architecture(name)(**kw).module, models.get(name, device="cpu", **kw).net


def _unet_jax_rules(arch_params):
    return tc.unet_key_mapper(jax_models.get_architecture("unet_custom")(num_classes=5, arch_params=arch_params).config)


def _strides(arch_params):
    return arch_params.get("backbone_params", {}).get("strides_list", (1, 2, 2, 2, 2))


CASES = {  # name: (builder of (JAX module, port net), port rules, JAX mapper or None, input size)
    "segformer_narrow": (lambda: (jax_us.SegFormer(jax_us.SegFormerCfg(**NARROW_SEGFORMER)),
                                  us.SegFormer(us.SegFormerCfg(**NARROW_SEGFORMER))),
                         SEGFORMER_RULES, tc.segformer_key_mapper(), (40, 56)),
    "unet_classic": (lambda: _zoo("unet_custom", (64, 64), arch_params=UNET_CLASSIC), unet_rules(_strides(UNET_CLASSIC)),
                     _unet_jax_rules(UNET_CLASSIC), (64, 64)),
    "unet_default_layout": (lambda: _zoo("unet_custom", (64, 64), arch_params=UNET_DEFAULT_LAYOUT),
                            unet_rules(_strides(UNET_DEFAULT_LAYOUT)), _unet_jax_rules(UNET_DEFAULT_LAYOUT), (64, 64)),
    "unet_cls": (lambda: _zoo("unet_custom_cls", arch_params=CLS_WIDTHS), unet_classifier_rules((1, 2, 2, 2, 2)), None,
                 (32, 32)),
}
EVAL_CASES = ["segformer_narrow", "unet_classic", "unet_default_layout", "unet_cls"]
TRAIN_CASES = ["segformer_narrow", "unet_classic"]


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
    """The JAX tree loads strictly into the port net, and (where the JAX package has a mapper)
    the port's ``state_dict`` converts strictly into the JAX tree; the parameter counts agree."""
    jax_rules = CASES[run.case][2]
    if jax_rules is not None:
        check_torch_keys_reach_jax(run.net, run.variables, jax_rules)
    assert tree_size(run.variables["params"]) == sum(p.numel() for p in run.net.parameters())


@pytest.mark.parametrize("run", EVAL_CASES, indirect=True)
def test_forward_eval_matches_jax_in_fp64(run):
    refs, got = run.eval
    hw = CASES[run.case][3]
    assert len(refs) == len(got) == 1 and got[0].shape == refs[0].shape == (
        (2, 5) if run.case == "unet_cls" else (2, *hw, 5))
    np.testing.assert_allclose(got[0], refs[0], rtol=1e-9, atol=1e-9)
    assert np.abs(refs[0]).max() > 0.1


@pytest.mark.parametrize("run", TRAIN_CASES, indirect=True)
def test_forward_train_mode_matches_jax_in_fp64(run):
    (j_outs, _, _), (p_outs, _, _, _) = run.step
    assert len(p_outs) == len(j_outs) == 1
    np.testing.assert_allclose(p_outs[0], j_outs[0], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("run", TRAIN_CASES, indirect=True)
def test_one_sgd_step_matches_jax_in_fp64(run):
    """The weights (LayerNorms, attention and MLP ``Linear``s, depthwise convs included) and
    every BN buffer after one step."""
    check_step(*run.step, CASES[run.case][1])


def test_same_pad_matches_xla():
    """The spatial-reduction conv's ``SAME`` padding: ``ceil(n / s)`` outputs, the odd pixel
    at the bottom or right, as ``flax.linen.Conv`` pads."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    for hw, s in (((18, 22), 8), ((9, 11), 4), ((5, 6), 2), ((16, 16), 4)):
        x = np.random.RandomState(s).randn(1, *hw, 3).astype(np.float32)
        conv = fnn.Conv(4, (s, s), strides=(s, s))
        v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
        ref = np.asarray(conv.apply(v, jnp.asarray(x)))
        tconv = torch.nn.Conv2d(3, 4, s, s)
        with torch.no_grad():
            tconv.weight.copy_(torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
            tconv.bias.zero_()
            got = tconv(us.same_pad(torch.from_numpy(x).permute(0, 3, 1, 2), s, s)).permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape == (1, -(-hw[0] // s), -(-hw[1] // s), 4)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


ZOO = {  # name: (parameters, task model, input size)
    "unet": (13_327_264, SegmentationModel, (512, 512)), "unet_custom": (13_327_264, SegmentationModel, (512, 512)),
    "unet_custom_cls": (19_872_168, ClassificationModel, (224, 224)),
    "segformer_b0": (3_719_027, SegmentationModel, (512, 1024)), "segformer_b1": (13_682_131, SegmentationModel, (512, 1024)),
    "segformer_b2": (27_361_235, SegmentationModel, (512, 1024)), "segformer_b3": (47_237_075, SegmentationModel, (512, 1024)),
    "segformer_b4": (64_007_635, SegmentationModel, (512, 1024)), "segformer_b5": (84_607_955, SegmentationModel, (512, 1024)),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_registers_the_family(name):
    """Every name builds the JAX spec's task model at its class count, input size and class
    names, with the JAX model's parameter count; the GPU default raises without a GPU."""
    expected, model_cls, hw = ZOO[name]
    model = models.get(name, device="cpu")
    jspec = jax_models.get_architecture(name)(num_classes=None, arch_params={})
    assert sum(p.numel() for p in model.net.parameters()) == expected
    assert expected == param_count(jspec.module, (1, *(jspec.init_hw or jspec.input_hw), 3), train=False)
    assert isinstance(model, model_cls) and model.num_classes == jspec.num_classes
    assert tuple(jspec.input_hw) == hw and model._class_names == jspec.class_names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.get(name)


def test_unet_recipe_arch_params_build_the_jax_layout():
    """``arch_params/unet_arch_params.yaml`` (over ``unet_default_arch_params``) loads in both
    packages to the same dict, and ``unet_custom`` of it has the JAX model's parameter count."""
    from super_gradients_tpu.common import config as jax_config
    from super_gradients_tpu_torch.common import config

    ap = config.load_arch_params("unet_arch_params")
    assert ap == jax_config.load_arch_params("unet_arch_params")
    net = models.get("unet_custom", num_classes=2, arch_params=ap, input_hw=(64, 64), device="cpu").net
    jspec = jax_models.get_architecture("unet_custom")(num_classes=2, arch_params=ap)
    assert sum(p.numel() for p in net.parameters()) == param_count(jspec.module, (1, 64, 64, 3), train=False)
    assert net.cfg.width_list == (64, 128, 256, 512, 512) and net.cfg.strides_list == (1, 2, 2, 2, 2)
