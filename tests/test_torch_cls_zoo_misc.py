"""The smaller classification families of the PyTorch port against the JAX package's modules, on
the same weights (``tests/torch_cls_parity.py``: the weights carried both ways, the fp32 eval
forward at ``rtol = 1e-4``, the fp64 train-mode forward and BN means at ``rtol = 1e-9``).

Cut sizes, 2 images each: VGG of widths 8-16 (``(8, M, 16, 16, M, 16, M)``) and LeNet at 32x32;
ShuffleNetV2 of stage widths (16, 32, 64) and repeats (2, 1, 1), DenseNet of growth 8, blocks
(2, 2, 2, 2) and 16 initial features, ResNeXt of one block a stage and cardinality 8, GoogLeNet at
its published widths, Darknet-53 of one block a stage and CSPDarknet-53 at width 0.25 and depth
0.33, at 64x64 (GoogLeNet at 72x72: its ceil-mode pools then meet odd maps); PreActResNet and
SENet of one block a stage, DPN of widths 32-64 and dense depth 8, PNASNet of one cell a stage and
16 planes, at 32x32. GoogLeNet's dropout is 0 on both sides.
"""

import numpy as np
import pytest
import torch

from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.models.classification import darknet as jax_darknet
from super_gradients_tpu.models.classification import dpn_pnasnet_beit as jax_dpb
from super_gradients_tpu.models.classification import misc_models as jax_misc
from super_gradients_tpu.models.classification import more_models as jax_more
from super_gradients_tpu.models.classification.more_models import _ceil_maxpool
from super_gradients_tpu_torch.conversion import from_jax
from super_gradients_tpu_torch.models.classification import darknet, dpn_pnasnet_beit, misc_models, more_models
from torch_cls_parity import check_eval, check_train64, check_weights_carry, run_family

torch.set_num_threads(2)
VGG_CUT = (8, "M", 16, 16, "M", 16, "M")
SHUFFLE_CUT = dict(num_classes=5, stage_channels=(16, 32, 64), stage_repeats=(2, 1, 1))
DENSE_CUT = dict(num_classes=5, growth_rate=8, block_config=(2, 2, 2, 2), init_features=16)
RESNEXT_CUT = dict(num_classes=5, num_blocks=(1, 1, 1, 1), cardinality=8)
DPN_CUT = dict(num_classes=5, in_planes=(32, 32, 64, 64), out_planes=(32, 64, 64, 64), num_blocks=(2, 1, 1, 1),
               dense_depth=(8, 8, 8, 8))
PNAS_CUT = dict(num_classes=5, num_cells=1, num_planes=16)
ONE_A_STAGE = dict(num_blocks=(1, 1, 1, 1), num_classes=5)


def _same(jax_cls, port_cls, **kw):
    return lambda: (jax_cls(**kw), port_cls(**kw))


CASES = {  # name: (build, port rules, the JAX mapper's rules, input size)
    "vgg": (lambda: (jax_misc.VGG(cfg=VGG_CUT, num_classes=5), misc_models.VGG(VGG_CUT, num_classes=5)),
            from_jax.vgg_rules(VGG_CUT), tc.vgg_key_mapper(VGG_CUT)(), (32, 32)),
    "lenet": (_same(jax_misc.LeNet, misc_models.LeNet, num_classes=5), (), (), (32, 32)),
    "shufflenet": (_same(jax_misc.ShuffleNetV2, misc_models.ShuffleNetV2, **SHUFFLE_CUT), from_jax.SHUFFLENET_RULES,
                   tc.shufflenet_key_mapper(), (64, 64)),
    "densenet": (_same(jax_misc.DenseNet, misc_models.DenseNet, **DENSE_CUT), from_jax.DENSENET_RULES,
                 tc.densenet_key_mapper(), (64, 64)),
    "resnext": (_same(jax_misc.ResNeXt, misc_models.ResNeXt, **RESNEXT_CUT), from_jax.RESNEXT_RULES,
                tc.resnext_key_mapper(), (64, 64)),
    "preact": (_same(jax_more.PreActResNet, more_models.PreActResNet, **ONE_A_STAGE), from_jax.PREACT_RULES,
               tc.preact_key_mapper(), (32, 32)),
    "googlenet": (_same(jax_more.GoogLeNet, more_models.GoogLeNet, num_classes=5, dropout=0.0), (), (), (72, 72)),
    "senet": (_same(jax_more.SENetCifar, more_models.SENetCifar, **ONE_A_STAGE), from_jax.SENET_RULES,
              tc.senet_key_mapper(), (32, 32)),
    "dpn": (_same(jax_dpb.DPN, dpn_pnasnet_beit.DPN, **DPN_CUT), from_jax.DPN_RULES, tc.dpn_key_mapper(), (32, 32)),
    "pnasnet": (_same(jax_dpb.PNASNet, dpn_pnasnet_beit.PNASNet, **PNAS_CUT), from_jax.PNASNET_RULES,
                tc.pnasnet_key_mapper(), (32, 32)),
    "darknet53": (_same(jax_darknet.Darknet53, darknet.Darknet53, num_classes=5, blocks=(1, 1, 1, 1, 1)),
                  from_jax.DARKNET53_RULES, tc.darknet53_key_mapper(), (64, 64)),
    "csp_darknet53": (_same(jax_darknet.CSPDarknet53, darknet.CSPDarknet53, num_classes=5, width_mult=0.25,
                            depth_mult=0.33), from_jax.CSP_DARKNET53_RULES, tc.csp_darknet53_key_mapper(), (64, 64)),
}


@pytest.fixture(scope="module", params=list(CASES))
def family(request):
    build, rules, jax_rules, hw = CASES[request.param]
    jmod, net = build()
    return run_family(request.param, jmod, net, rules, jax_rules, hw)


def test_weights_carry_both_ways(family):
    check_weights_carry(family)


def test_forward_eval_matches_jax(family):
    check_eval(family)


def test_forward_train_mode_matches_jax_in_fp64(family):
    check_train64(family)


@pytest.mark.parametrize("size", [7, 8, 9, 14, 15, 17, 28, 29, 56, 57, 112, 113])
def test_ceil_max_pool_windows_match_jax(size):
    """GoogLeNet's ceil-mode pools (3/2 and 2/2) take the JAX windows on even and odd maps, and
    ``F.max_pool2d(ceil_mode=True)`` takes the same ones at every size here."""
    import jax.numpy as jnp

    x = np.random.RandomState(size).randn(1, 2, size, size + 1).astype(np.float32)
    for k, s in ((3, 2), (2, 2)):
        ref = np.asarray(_ceil_maxpool(jnp.asarray(x.transpose(0, 2, 3, 1)), k, s)).transpose(0, 3, 1, 2)
        got = more_models.ceil_max_pool(torch.from_numpy(x), k, s).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(torch.nn.functional.max_pool2d(torch.from_numpy(x), k, s, ceil_mode=True), ref)


def test_shufflenet_channel_shuffle_interleaves_the_halves():
    x = torch.arange(8.0).reshape(1, 8, 1, 1)
    assert misc_models.channel_shuffle(x).flatten().tolist() == [0, 4, 1, 5, 2, 6, 3, 7]


def test_googlenet_dropout_mask():
    """Dropout before ``fc``: identity in eval mode; in train mode each pooled feature kept (scaled
    by 1 / (1 - p)) or zeroed, a fresh seeded mask each call."""
    drop = more_models.GoogLeNet(num_classes=5).dropout
    x = torch.ones(8, 64)
    assert drop.p == 0.2 and torch.equal(drop.eval()(x), x)
    drop.train()
    a, b = drop(x), drop(x)
    assert set(a.unique().tolist()) <= {0.0, 1.25} and not torch.equal(a, b)
    assert 0.1 < float((a == 0).float().mean()) < 0.3


def test_lenet_flattens_in_the_jax_nhwc_order_in_both_packages():
    """JAX LeNet flattens its NHWC map (height, width, channel) before ``fc1``, where the original
    flattens NCHW: the port keeps JAX's order, so ``fc1`` of an original checkpoint would read its
    inputs permuted in both packages (ROADMAP.md section 3). Only ``fc1``'s column order tells the
    two apart: a ``fc1`` that reads one (channel, row, column) of the port's map reads it where the
    JAX tree puts it."""
    import jax
    import jax.numpy as jnp

    torch.manual_seed(0)
    net = misc_models.LeNet(num_classes=5).double().eval()
    feats = {}
    net.conv2.register_forward_hook(lambda m, i, o: feats.__setitem__("conv2", o))
    x = torch.randn(1, 3, 32, 32, dtype=torch.float64)
    with torch.no_grad():
        net(x)
        pooled = torch.nn.functional.max_pool2d(torch.relu(feats["conv2"]), 2, 2)[0]
        c, h, w = np.unravel_index(int(pooled.argmax()), (16, 5, 5))  # a positive feature of the 16x5x5 map
        for p in (net.fc1.weight, net.fc1.bias, net.fc2.bias, net.fc3.bias, net.fc2.weight, net.fc3.weight):
            p.zero_()
        net.fc1.weight[0, (h * 5 + w) * 16 + c] = 1.0  # its NHWC-flattened index
        net.fc2.weight[0, 0] = 1.0
        net.fc3.weight[0, 0] = 1.0
        out = net(x)
    assert float(out[0, 0]) == float(pooled[c, h, w]) > 0
    jmod = jax_misc.LeNet(num_classes=5)

    def leaf(layer):
        w, b = layer.weight.detach().numpy(), layer.bias.detach().numpy()
        return {"kernel": w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0), "bias": b}

    variables = {"params": {k: leaf(getattr(net, k)) for k in ("conv1", "conv2", "fc1", "fc2", "fc3")}}
    with jax.enable_x64():
        ref = jmod.apply(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables),
                         jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    assert abs(float(ref[0, 0]) - float(out[0, 0])) <= 1e-12 * float(out[0, 0])
