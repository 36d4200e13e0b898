"""EfficientNet, RegNetY and RepVGG of the PyTorch port against the JAX package's modules, on the
same weights (``tests/torch_cls_parity.py``: the weights carried both ways, the fp32 eval forward
at ``rtol = 1e-4``, the fp64 train-mode forward and BN means at ``rtol = 1e-9``).

Cut sizes, 2 images each:

- EfficientNet at width 0.25 and depth 0.35 (10 blocks, one or two a stage: every kernel and
  stride of B0, four residual blocks), 64x64: the stride-2 convs pad as XLA's ``SAME`` ((0, 1) on
  every even map);
- RegNetY (``custom_regnet``) of initial width 8, slope 8, q 2.0, depth 4, group width 8: three
  stages, grouped 3x3 convs and the SE of the block input, 64x64;
- RepVGG at widths 0.25 / 0.25 with blocks (2, 2, 1, 1), with and without the squeeze-excitation
  (``se_ratio`` 1 / 4), 64x64; its deploy form (``fuse_repvgg``) against the unfused port net and
  against JAX's ``fused="full"`` after ``fuse_repvgg_params``.

The RepVGG block alone with 2 groups, dilation 2, the identity branch and the SE is held to the JAX
block in fp64, its deploy form too. Dropout is 0 on both sides in the parity cases; EfficientNet's
mask is tested on its own.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.models.classification import efficientnet as jax_eff
from super_gradients_tpu.models.classification import regnet as jax_regnet
from super_gradients_tpu.models.classification import repvgg as jax_repvgg
from super_gradients_tpu.modules.blocks import RepVGGBlock as JaxRepVGGBlock
from super_gradients_tpu.modules.blocks import fuse_repvgg_params
from super_gradients_tpu_torch.conversion import from_jax
from super_gradients_tpu_torch.models.classification import efficientnet, regnet, repvgg
from super_gradients_tpu_torch.modules.blocks import RepVGGBlock, same_pad
from torch_cls_parity import check_eval, check_train64, check_weights_carry, run_family

torch.set_num_threads(2)
HW = (64, 64)
EFF_CUT = dict(num_classes=5, width_coeff=0.25, depth_coeff=0.35, dropout=0.0)
REGNET_CUT = dict(num_classes=5, initial_width=8, slope=8, quantized_param=2.0, depth=4, group_width=8, se_ratio=0.25)
REPVGG_CUT = dict(num_classes=5, blocks_per_stage=(2, 2, 1, 1), width_a=0.25, width_b=0.25)


def _repvgg_pair(se_ratio):
    return (jax_repvgg.RepVGG(jax_repvgg.RepVGGCfg(se_ratio=se_ratio, **REPVGG_CUT)),
            repvgg.RepVGG(repvgg.RepVGGCfg(se_ratio=se_ratio, **REPVGG_CUT)))


CASES = {
    "efficientnet": (lambda: (jax_eff.EfficientNet(**EFF_CUT), efficientnet.EfficientNet(**EFF_CUT)),
                     from_jax.EFFICIENTNET_RULES, tc.efficientnet_key_mapper()),
    "regnet": (lambda: (jax_regnet.RegNetY(**REGNET_CUT), regnet.RegNetY(**REGNET_CUT)),
               from_jax.REGNET_RULES, tc.regnet_key_mapper()),
    "repvgg": (lambda: _repvgg_pair(0.0), from_jax.REPVGG_RULES, tc.repvgg_key_mapper()),
    "repvgg_se": (lambda: _repvgg_pair(0.25), from_jax.REPVGG_RULES, tc.repvgg_key_mapper()),
}


@pytest.fixture(scope="module", params=list(CASES))
def family(request):
    build, rules, jax_rules = CASES[request.param]
    jmod, net = build()
    return run_family(request.param, jmod, net, rules, jax_rules, HW)


def test_weights_carry_both_ways(family):
    check_weights_carry(family)


def test_forward_eval_matches_jax(family):
    check_eval(family)


def test_forward_train_mode_matches_jax_in_fp64(family):
    check_train64(family)


def test_cut_sizes_reach_what_they_claim():
    """The cut EfficientNet has a block of every stage's kernel and stride and residual blocks,
    the cut RegNetY three stages with grouped convs, the cut RepVGG identity branches."""
    net = efficientnet.EfficientNet(**EFF_CUT)
    kinds = {(b._depthwise_conv.kernel_size[0], b._depthwise_conv.stride[0], b.expand) for b in net._blocks}
    assert kinds == {(3, 1, False), (3, 2, True), (5, 2, True), (5, 1, True), (3, 1, True)}
    assert len(net._blocks) == 10 and sum(b.use_residual for b in net._blocks) == 4
    widths, depths = regnet.generate_widths(8, 8, 2.0, 4, 8)
    assert len(widths) == 3 and max(w // 8 for w in widths) > 1
    net = repvgg.RepVGG(repvgg.RepVGGCfg(**REPVGG_CUT))
    assert sum(isinstance(m, RepVGGBlock) and m.use_residual for m in net.modules()) == 2


def test_generate_widths_matches_jax_number_for_number():
    for iw, slope, q, depth, gw, _ in list(regnet.REGNETY_PARAMS.values()) + [(24, 36.44, 2.49, 13, 8, 0),
                                                                               (8, 8, 2.0, 4, 8, 0)]:
        assert regnet.generate_widths(iw, slope, q, depth, gw) == jax_regnet._generate_widths(iw, slope, q, depth, gw)


def test_round_filters_and_repeats_match_jax():
    for variant, (w, d, _, _) in efficientnet.EFFICIENTNET_PARAMS.items():
        for c in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
            assert efficientnet.round_filters(c, w) == jax_eff._round_filters(c, w), (variant, c)
        for n in (1, 2, 3, 4):
            assert efficientnet.round_repeats(n, d) == jax_eff._round_repeats(n, d), (variant, n)


def test_stem_pads_as_xla_same_at_224():
    """At 224 the stride-2 3x3 stem pads (0, 1) on each axis: one row and column, at the end."""
    x = torch.zeros(1, 1, 224, 224)
    padded = same_pad(x + 1, 3, 2)
    assert padded.shape[-2:] == (225, 225) and padded[..., 0, :].sum() > 0 and padded[..., -1, :].sum() == 0


def test_efficientnet_dropout_mask():
    """Dropout before ``_fc``: identity in eval mode; in train mode each pooled feature is kept
    (scaled by 1 / (1 - p)) or zeroed, a fresh seeded mask each call."""
    net = efficientnet.EfficientNet(num_classes=5, width_coeff=0.25, depth_coeff=0.35, dropout=0.5)
    x = torch.ones(4, 64)
    drop = net._dropout
    assert torch.equal(drop.eval()(x), x)
    drop.train()
    a, b = drop(x), drop(x)
    assert set(a.unique().tolist()) <= {0.0, 2.0} and not torch.equal(a, b)
    assert 0.3 < float((a == 0).float().mean()) < 0.7


def _fused_jax_params(params, stats, cfg):
    """The JAX variables of ``fused="full"``: every RepVGG block through ``fuse_repvgg_params``,
    the squeeze-excitation and the head kept."""

    def walk(p, s):
        if "branch_3x3_conv" in p:
            k = p["branch_3x3_conv"]["kernel"]
            block = JaxRepVGGBlock(out_channels=int(k.shape[3]), use_residual="identity_bn" in p)
            out = fuse_repvgg_params(p, s, block)
            return dict(out, **({"se": p["se"]} if "se" in p else {}))
        return {k: walk(v, s.get(k, {})) if isinstance(v, dict) else v for k, v in p.items()}

    return walk(params, stats)


@pytest.mark.parametrize("se_ratio", [0.0, 0.25])
def test_repvgg_deploy_form_matches_unfused_and_jax(se_ratio):
    """``fuse_repvgg`` in place equals the unfused port net (eval mode, fp64, 1e-9 of the largest
    logit) and the JAX ``fused="full"`` module on the fused JAX variables (fp32, 1e-4); the fused
    port net's ``state_dict`` is the fused JAX tree through ``REPVGG_RULES``."""
    jmod, net = _repvgg_pair(se_ratio)
    from torch_seg_parity import load_port, seeded_variables

    variables = seeded_variables(jmod, HW, seed=7)
    load_port(net, variables, from_jax.REPVGG_RULES)
    x = np.random.RandomState(3).randn(2, *HW, 3)
    net64 = repvgg.RepVGG(repvgg.RepVGGCfg(se_ratio=se_ratio, **REPVGG_CUT))
    net64.load_state_dict(net.state_dict())
    net64 = net64.double().eval()
    with torch.no_grad():
        unfused = net64(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        fused = repvgg.fuse_repvgg(net64)(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert all(b.fused for b in net64.modules() if isinstance(b, RepVGGBlock))
    np.testing.assert_allclose(fused, unfused, rtol=1e-9, atol=1e-9 * np.abs(unfused).max())

    fused_params = _fused_jax_params(variables["params"], variables["batch_stats"], None)
    jfused = jax_repvgg.RepVGG(dataclasses.replace(jmod.cfg, fused="full"))
    ref = np.asarray(jax.jit(functools.partial(jfused.apply, train=False))({"params": fused_params},
                                                                          jnp.asarray(x, jnp.float32)))
    port_fused = repvgg.RepVGG(repvgg.RepVGGCfg(se_ratio=se_ratio, fused=True, **REPVGG_CUT))
    port_fused.load_state_dict(from_jax.variables_from_jax_to_torch(
        {"params": jax.tree_util.tree_map(np.asarray, fused_params)}, from_jax.REPVGG_RULES))
    with torch.no_grad():
        got = port_fused.eval()(torch.from_numpy(x.astype(np.float32)).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(got, unfused, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_repvgg_block_groups_dilation_and_se_match_jax():
    """The block alone with what no registered RepVGG uses: 2 groups, dilation 2, the identity BN
    and the squeeze-excitation, on 8 channels at 12x12. Eval and train mode (batch-statistics BN)
    in fp64 at 1e-9 against the JAX block, and the port's ``fuse_`` against the JAX block's
    ``fused="full"`` on ``fuse_repvgg_params``' variables (the identity kernel across groups)."""
    from torch_seg_parity import load_port, seeded_variables

    kw = dict(groups=2, dilation=2, use_residual=True, se_ratio=0.25)
    jblock = JaxRepVGGBlock(out_channels=8, **kw)
    variables = seeded_variables(jblock, (12, 12), seed=5, channels=8)
    block = load_port(RepVGGBlock(8, 8, **kw), variables, from_jax.REPVGG_RULES).double()
    x = np.random.RandomState(6).randn(2, 12, 12, 8)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        ref_eval = np.asarray(jblock.apply(v64, jnp.asarray(x), train=False))
        ref_train, _ = jblock.apply(v64, jnp.asarray(x), train=True, mutable=["batch_stats"])
        fused = fuse_repvgg_params(v64["params"], v64["batch_stats"], jblock)
        ref_fused = np.asarray(JaxRepVGGBlock(out_channels=8, fused="full", **kw).apply(
            {"params": dict(fused, se=v64["params"]["se"])}, jnp.asarray(x), train=False))
    with torch.no_grad():
        got_eval = block.eval()(xt).permute(0, 2, 3, 1).numpy()
        got_train = copy.deepcopy(block).train()(xt).permute(0, 2, 3, 1).numpy()
        got_fused = block.fuse_()(xt).permute(0, 2, 3, 1).numpy()
    assert block.fused and block.rbr_reparam.groups == 2 and block.rbr_reparam.dilation == (2, 2)
    np.testing.assert_allclose(got_eval, ref_eval, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got_train, np.asarray(ref_train), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got_fused, ref_fused, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got_fused, ref_eval, rtol=1e-9, atol=1e-9)
