"""ShelfNet (LW and HW) and LadderNet of the PyTorch port against the JAX package's modules, on
the same weights.

The JAX variables are drawn from a numpy seed over the JAX module's traced init and carried
into the port through ``conversion/from_jax.py`` (strict); the port's ``state_dict`` also
converts back into the JAX tree through the JAX package's ``shelfnet_key_mapper``. The JAX
ShelfNet config has no width knob, so the published widths run at 64x64 (5 classes). Every
comparison is in fp64 on both sides at ``rtol = atol = 1e-9`` (``tests/torch_seg_parity.py``):

- ``shelfnet18_lw``: the eval logits, the three train-mode maps and one SGD step of their
  summed cross-entropy (weights, BN running means, BN running variances through ``n / (n - 1)``);
- ``shelfnet50`` (the HW path: transposed convs, SE, FCN aux head): the eval logits and the
  train-mode ``(main, se, aux)``;
- ``laddernet_50``: the eval logits and one step.

Train mode runs with every dropout at 0 on both sides: in JAX through ``monkeypatch`` on the
JAX module's ``nn`` namespace (its ``Dropout`` at rate 0, which flax returns unchanged), in the
port by setting each ``SeededChannelDropout``'s ``p``; the port's channel masks are tested
apart. The registry builds all six names at their JAX parameter counts.
"""

import copy
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.models.segmentation import shelfnet_laddernet as jax_shelf
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import SHELFNET_RULES
from super_gradients_tpu_torch.models.segmentation import shelfnet_laddernet as shelf
from super_gradients_tpu_torch.models.segmentation.stdc import SeededChannelDropout, SeededDropout
from torch_jax_init import FP64_COMPILE, param_count
from torch_seg_parity import (
    RTOL,
    check_step,
    check_torch_keys_reach_jax,
    load_port,
    port_eval64,
    port_step64,
    jax_reference64,
    seeded_variables,
    tree_size,
)

torch.set_num_threads(2)

HW = (64, 64)
NAMES = ["shelfnet18_lw", "shelfnet34_lw", "shelfnet50", "shelfnet50_3343", "shelfnet101", "laddernet_50"]


def no_dropout_nn():
    """The JAX module's ``nn`` with every ``Dropout`` at rate 0."""
    return types.SimpleNamespace(**{**vars(flax.linen), "Dropout": lambda rate, *a, **k: flax.linen.Dropout(0.0, *a, **k)})


def zero_dropout(net):
    for m in net.modules():
        if isinstance(m, SeededDropout):
            m.p = 0.0
    return net


def _build(name):
    spec = jax_models.get_architecture(name)(num_classes=5, input_hw=HW)
    return spec.module, zero_dropout(models.get(name, num_classes=5, input_hw=HW, device="cpu").net)


def jax_outputs64(module, variables, x_eval, x_train):
    """The JAX module's fp64 eval outputs on ``x_eval`` and train-mode outputs on ``x_train``
    (batch statistics), one compiled program."""
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def program(v, xe, xt):
            train_out, _ = module.apply(v, xt, train=True, mutable=["batch_stats"])
            return module.apply(v, xe, train=False), train_out

        ev, tr = jax.jit(program, compiler_options=FP64_COMPILE)(v64, jnp.asarray(x_eval), jnp.asarray(x_train))
        return np.asarray(ev), [np.asarray(o) for o in tr]


CASES = {  # name: (port rules, JAX mapper or None, what runs: "step" or "train_outputs")
    "shelfnet18_lw": (SHELFNET_RULES, tc.shelfnet_key_mapper(), "step"),
    "shelfnet50": (SHELFNET_RULES, tc.shelfnet_key_mapper(), "train_outputs"),
    "laddernet_50": (SHELFNET_RULES, None, "step"),
}


@pytest.fixture(scope="module")
def runs():
    return {}


@pytest.fixture
def run(request, runs):
    """A case's JAX module, variables and port net, and both packages' fp64 results, computed
    once in the module with JAX's dropout at 0."""
    name = request.param
    if name not in runs:
        rules, _, what = CASES[name]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_shelf, "nn", no_dropout_nn())
            jmod, net = _build(name)
            variables = seeded_variables(jmod, HW, seed=len(name))
            load_port(net, variables, rules)
            x_eval = np.random.RandomState(3).randn(2, *HW, 3)
            rng = np.random.RandomState(11)
            x, labels = rng.randn(2, *HW, 3), rng.randint(0, 5, (2, *HW)).astype(np.int32)
            if what == "step":
                j_eval, j_step = jax_reference64(jmod, variables, x_eval, (x, labels))
                result = dict(eval=(j_eval[0], port_eval64(net, x_eval)[0]),
                              step=(j_step, port_step64(copy.deepcopy(net), x, labels)))
            else:
                j_eval, j_train = jax_outputs64(jmod, variables, x_eval, x)
                with torch.no_grad():
                    p_train = copy.deepcopy(net).double().train()(torch.from_numpy(x).permute(0, 3, 1, 2))
                result = dict(eval=(j_eval, port_eval64(net, x_eval)[0]), train=(j_train, p_train))
        runs[name] = types.SimpleNamespace(name=name, variables=variables, net=net, **result)
    return runs[name]


@pytest.mark.parametrize("run", list(CASES), indirect=True)
def test_weights_convert_both_ways(run):
    """The JAX tree loads strictly into the port net; ShelfNet's ``state_dict`` converts strictly
    into the JAX tree through the JAX package's ``shelfnet_key_mapper``; the counts agree."""
    mapper = CASES[run.name][1]
    if mapper is not None:
        check_torch_keys_reach_jax(run.net, run.variables, mapper)
    assert tree_size(run.variables["params"]) == sum(p.numel() for p in run.net.parameters())


@pytest.mark.parametrize("run", list(CASES), indirect=True)
def test_forward_eval_matches_jax_in_fp64(run):
    ref, got = run.eval
    assert got.shape == (2, *HW, 5)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL)
    assert np.abs(ref).max() > 0.1


@pytest.mark.parametrize("run", ["shelfnet18_lw", "laddernet_50"], indirect=True)
def test_train_mode_outputs_and_one_sgd_step_match_jax_in_fp64(run):
    """LW's three train-mode maps (LadderNet's one) and one SGD step of their summed CE: the
    weights, ``conv1``'s gradient summing both of its uses in every ShelfBlock, every BN buffer."""
    (j_outs, _, _), (p_outs, _, _, _) = run.step
    assert len(p_outs) == len(j_outs) == (3 if run.name == "shelfnet18_lw" else 1)
    for got, ref in zip(p_outs, j_outs):
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL)
    check_step(*run.step, CASES[run.name][0])


@pytest.mark.parametrize("run", ["shelfnet50"], indirect=True)
def test_hw_train_mode_main_se_aux_match_jax_in_fp64(run):
    """HW's train mode: ``(main [B, C, H, W], se [B, C], aux [B, C, H, W])``, the SE encoding from
    the spatial max of the ladder's bottom map, the aux head on the trunk's stride-16 map."""
    j_out, p_out = run.train
    assert [tuple(o.shape) for o in p_out] == [(2, 5, *HW), (2, 5), (2, 5, *HW)]
    for got, ref in zip(p_out, j_out):
        got = got.permute(0, 2, 3, 1).numpy() if got.dim() == 4 else got.numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_registry_builds_every_name_at_the_jax_parameter_count(name):
    spec = jax_models.get_architecture(name)(num_classes=21, input_hw=HW)
    net = models.get(name, num_classes=21, input_hw=HW, device="cpu").net
    assert sum(p.numel() for p in net.parameters()) == param_count(spec.module, (1, *HW, 3), train=False)


def test_laddernet_50_keeps_the_jax_basicblock_2222_trunk():
    """A fault of the JAX package kept in the port (ROADMAP.md section 3): ``laddernet_50``'s trunk
    is BasicBlock 2-2-2-2 (ResNet-18's), not a ResNet-50 in both packages."""
    shapes = jax.eval_shape(lambda: jax_models.get_architecture("laddernet_50")(num_classes=3, input_hw=HW).module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), train=False))["params"]["backbone"]
    assert sorted(k for k in shapes if k.startswith("layer")) == [f"layer{i}_{j}" for i in range(1, 5) for j in (0, 1)]
    assert all("conv3" not in shapes[k] for k in shapes if k.startswith("layer"))
    net = models.get("laddernet_50", num_classes=3, input_hw=HW, device="cpu").net
    layers = [getattr(net.backbone, f"layer{i}") for i in range(1, 5)]
    assert [len(layer) for layer in layers] == [2, 2, 2, 2]
    assert all(isinstance(b, shelf.BasicResNetBlock) for layer in layers for b in layer)


def test_outputs_by_mode_and_aux_outputs():
    """LW: one map in eval mode (heads 1-2 not run), three in train mode or with
    ``aux_outputs``; HW: the main map in eval mode, ``(main, se, aux)`` with ``aux_outputs``."""
    x = torch.rand(1, 3, *HW)
    lw = models.get("shelfnet18_lw", num_classes=3, input_hw=HW, device="cpu").net.eval()
    ran = []
    lw.net_output_list[1].register_forward_hook(lambda *a: ran.append(1))
    with torch.no_grad():
        assert lw(x).shape == (1, 3, *HW) and ran == []
    lw_aux = models.get("shelfnet18_lw", num_classes=3, input_hw=HW, arch_params={"aux_outputs": True},
                        device="cpu").net.eval()
    with torch.no_grad():
        assert [o.shape for o in lw_aux(x)] == [(1, 3, *HW)] * 3
        hw = models.get("shelfnet50", num_classes=3, input_hw=HW, arch_params={"aux_outputs": True}, device="cpu").net
        main, se, aux = hw.eval()(x)
        assert main.shape == aux.shape == (1, 3, *HW) and se.shape == (1, 3)
        hw.cfg = shelf.ShelfNetCfg(num_classes=3, variant="50")
        assert torch.equal(hw(x), main)


def test_channel_dropout_masks():
    """The ShelfBlock and FCN-head dropouts drop whole channels (constant over H and W), only in
    train mode, at their rates, repeatably from the block's seed."""
    x = torch.ones(4, 64, 6, 5)
    drop = SeededChannelDropout(shelf.SHELF_DROPOUT, seed=7)
    y = drop.train()(x)
    assert torch.equal(y, y[..., :1, :1].expand_as(y))
    assert torch.unique(y).tolist() == [0.0, float(torch.tensor(1.0) / (1 - shelf.SHELF_DROPOUT))]
    assert 0.1 < float((y[:, :, 0, 0] == 0).float().mean()) < 0.4
    assert torch.equal(SeededChannelDropout(shelf.SHELF_DROPOUT, seed=7).train()(x), y)
    assert not torch.equal(drop(x), y)  # the next call draws the next seed's mask
    assert torch.equal(drop.eval()(x), x)
    net = models.get("shelfnet50", num_classes=3, input_hw=HW, device="cpu").net
    drops = [m for m in net.modules() if isinstance(m, SeededChannelDropout)]
    assert sorted({m.p for m in drops}) == [shelf.FCN_DROPOUT, shelf.SHELF_DROPOUT]
    assert len({m.seed for m in drops}) == len(drops)


def test_original_checkpoint_with_the_unused_decoder_inconv_loads(tmp_path, monkeypatch):
    """An original ShelfNet ``state_dict`` holds ``decoder.inconv`` (``DecoderBase.inconv``, a 3x3
    conv no forward calls): ``checkpoint_path=`` and ``pretrained_weights=`` load it strictly, the
    conv is not built, and the predictions are those of the same weights without it."""
    base = models.get("shelfnet34_lw", num_classes=21, input_hw=HW, seed=3, device="cpu")
    sd = dict(base.net.state_dict())
    sd["decoder.inconv.weight"] = torch.randn(128, 128, 3, 3)
    sd["decoder.inconv.bias"] = torch.randn(128)
    monkeypatch.setenv("SG_PRETRAINED_DIR", str(tmp_path))
    torch.save({"net": sd}, tmp_path / "shelfnet34_lw_coco_segmentation_subclass.pth")
    x = torch.rand(1, 3, *HW)
    with torch.no_grad():
        want = base.net.eval()(x)
        for kw in ({"checkpoint_path": str(tmp_path / "shelfnet34_lw_coco_segmentation_subclass.pth")},
                   {"pretrained_weights": "coco_segmentation_subclass"}):
            model = models.get("shelfnet34_lw", num_classes=21, input_hw=HW, device="cpu", **kw)
            assert not any("inconv" in k and k.startswith("decoder.") for k in model.net.state_dict())
            torch.testing.assert_close(model.net.eval()(x), want, rtol=0, atol=0)
