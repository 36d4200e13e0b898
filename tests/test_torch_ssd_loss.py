"""SSDLoss of the PyTorch port against the JAX package's, and one step of the new recipes'
criteria.

The loss cases run on the SSD-lite anchor grid of a 64 px model (``heads.SSDHead.anchors``
feature sizes 4, 2, 1, 1, 1, 1: 144 anchors) with seeded raw confs ``[B, A, 5]`` and locs
``[B, A, 4]`` and padded ``[B, 6, 5]`` targets. Held: the positives and the matched gts
exactly, the total, ``loc_loss`` and ``conf_loss`` at ``rtol=1e-5`` and the gradients of
both raw maps at ``atol=1e-6, rtol=1e-4``. The tie fixture gives every anchor of an image
the same confs (equal CEs among the negatives, so the stable descending sort decides which
negatives are mined) and two gts the same best anchor (forced by both, matched to the
argmax gt); it asserts that both are there.

The recipe step (:func:`_check_one_step`): one SGD step of each new recipe's criterion and
optimizer as the recipe sets them, on a train-mode forward in fp64 on both sides
(``jax.enable_x64``): ``coco2017_ssd_lite_mobilenet_v2`` (``SSDLoss`` from
``criterion_params``, given the anchor grid above) on a 64 px SSD-lite with that grid,
``imagenet_mobilenetv2`` and
``imagenet_mobilenetv3_large`` (``LabelSmoothingCrossEntropyLoss``) on a MobileNetV2 and a
MobileNetV3-large at width 0.5 and 64 px. The loss, every parameter's gradient (backbone,
neck and SE blocks included) and every parameter's move in the step at ``rtol=1e-6``, atol
1e-6 of the tensor's largest magnitude (at least 1e-12, the fp64 noise of a gradient that
is zero in exact arithmetic, as a conv bias before a BN): SSD's heads cast their raw maps to
fp32 in both packages, so its loss sees fp32 inputs that can differ by an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from super_gradients_tpu.common import config as jax_config
from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.models.detection.yolo_nas import YoloNASOutputs as JaxOutputs
from super_gradients_tpu.training.losses import get_loss as jax_get_loss
from super_gradients_tpu.training import optimizers as jax_optimizers
from super_gradients_tpu.training.losses.ssd_loss import SSDLoss as JaxSSDLoss
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.common import config
from super_gradients_tpu_torch.conversion import from_jax
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.models.detection.ssd import generate_ssd_anchors
from super_gradients_tpu_torch.models.detection.yolo_nas import YoloNASOutputs
from super_gradients_tpu_torch.models.segmentation.stdc import SeededDropout
from super_gradients_tpu_torch.training.losses import get_loss
from super_gradients_tpu_torch.training.losses.ssd_loss import SSDLoss
from super_gradients_tpu_torch.training.optimizers import build_optimizer
from torch_jax_init import FP64_COMPILE, jax_model

torch.set_num_threads(2)

C = 4
ANCHORS = generate_ssd_anchors(64, (4, 2, 1, 1, 1, 1), (6, 16, 27, 37, 47, 57, 67))
A = len(ANCHORS)


def random_case(seed, b=2):
    rng = np.random.RandomState(seed)
    conf = (rng.randn(b, A, C + 1) * 2).astype(np.float32)
    loc = rng.randn(b, A, 4).astype(np.float32)
    t = -np.ones((b, 6, 5), np.float32)
    for i in range(b):
        for j in range(4 - i):
            x1, y1 = rng.uniform(0, 44, 2)
            w, h = rng.uniform(4, 30, 2)
            t[i, j] = [rng.randint(C), x1, y1, min(x1 + w, 64), min(y1 + h, 64)]
    return conf, loc, t


def tie_case():
    """Image 0: every anchor has the same confs (so the negatives' CEs are equal) and two small
    gts inside one 16 px cell share their best anchor; image 1 as drawn."""
    conf, loc, t = random_case(3)
    conf[0] = conf[0, :1]
    t[0, :4] = -1
    t[0, 0] = [1, 2.0, 2.0, 10.0, 10.0]
    t[0, 1] = [2, 3.0, 3.0, 11.0, 9.0]
    return conf, loc, t


CASES = {"random": lambda: random_case(0), "random_b3": lambda: random_case(1, b=3), "ties": tie_case}


def _outputs(conf, loc, lib):
    if lib == "jax":
        return JaxOutputs(None, None, jnp.asarray(conf), jnp.asarray(loc), None, None, None)
    return YoloNASOutputs(None, None, conf, loc, None, None, None)


def _both(case):
    conf, loc, t = CASES[case]()
    jl, pl = JaxSSDLoss(anchors_cxcywh=ANCHORS), SSDLoss(anchors_cxcywh=ANCHORS)

    def jax_total(c, l_):
        loss, aux = jl(_outputs(c, l_, "jax"), jnp.asarray(t))
        return loss, aux

    (jv, jaux), (gc, gl) = jax.jit(jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True))(
        jnp.asarray(conf), jnp.asarray(loc))
    pc, plc = torch.tensor(conf, requires_grad=True), torch.tensor(loc, requires_grad=True)
    pv, paux = pl(_outputs(pc, plc, "torch"), torch.from_numpy(t))
    pv.backward()
    return (jv, jaux, np.asarray(gc), np.asarray(gl)), (pv, paux, pc.grad.numpy(), plc.grad.numpy()), pl, t


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    (jv, jaux, jgc, jgl), (pv, paux, pgc, pgl), _, _ = _both(case)
    assert sorted(paux) == sorted(jaux) == ["conf_loss", "loc_loss"]
    np.testing.assert_allclose(pv.item(), float(jv), rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(paux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(pgc, jgc, atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(pgl, jgl, atol=1e-6, rtol=1e-4)
    assert np.abs(jgc).max() > 0 and np.abs(jgl).max() > 0


def _jax_match(t):
    """The JAX loss's positives and matched gts, recomputed by its own ops."""
    from super_gradients_tpu.ops.bbox import box_iou, cxcywh_to_xyxy

    pad = (t[..., 0] >= 0).astype(np.float32)
    ious = np.asarray(box_iou(jnp.asarray(t[..., 1:5]), cxcywh_to_xyxy(jnp.asarray(ANCHORS))[None])) * pad[..., None]
    best_gt = ious.argmax(1)
    force = np.zeros(best_gt.shape, bool)
    for b, n in zip(*np.nonzero(pad)):
        force[b, ious[b, n].argmax()] = True
    return (ious.max(1) >= 0.5) | force, best_gt, ious


@pytest.mark.parametrize("case", sorted(CASES))
def test_matching_matches_jax(case):
    _, _, t = CASES[case]()
    pos, best_gt, conf_target = SSDLoss(anchors_cxcywh=ANCHORS).match(torch.from_numpy(t))
    jpos, jbest, _ = _jax_match(t)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(best_gt.numpy()[jpos], jbest[jpos])
    assert int(pos.sum()) > 0


def test_tie_fixture_reaches_the_ties():
    """Image 0's negatives have equal CEs, more of them than are mined (so the stable sort
    picks the lowest indices), and its two gts force the same anchor, which keeps the argmax
    gt (the first on equal IoU, else the higher IoU)."""
    _, _, t = tie_case()
    conf, _, _ = tie_case()
    pos, best_gt, target = SSDLoss(anchors_cxcywh=ANCHORS).match(torch.from_numpy(t))
    _, _, ious = _jax_match(t)
    a0, a1 = ious[0, 0].argmax(), ious[0, 1].argmax()
    assert a0 == a1 and bool(pos[0, a0])
    assert int(best_gt[0, a0]) == int(ious[0, :, a0].argmax())
    neg = ~pos[0]
    logp = torch.log_softmax(torch.from_numpy(conf[0]), -1)[:, 0]
    assert len(torch.unique(logp[neg])) == 1
    n_pos = int(pos[0].sum())
    assert 3 * n_pos < int(neg.sum())


def test_recipe_loss_needs_the_lite_grid_in_both_packages():
    """``SSDLoss`` built from ``criterion_params`` alone makes the SSD-lite grid (3,234 anchors
    at 320): on SSD-MobileNetV1's 9,602 anchors it raises in both packages."""
    t = np.array([[[1, 10.0, 10.0, 60.0, 80.0]]], np.float32)
    conf, loc = np.zeros((1, 9602, 81), np.float32), np.zeros((1, 9602, 4), np.float32)
    assert len(JaxSSDLoss().anchors) == len(SSDLoss().anchors) == 3234
    with pytest.raises((TypeError, ValueError)):
        JaxSSDLoss()(_outputs(conf, loc, "jax"), jnp.asarray(t))
    with pytest.raises(RuntimeError):
        SSDLoss()(_outputs(torch.from_numpy(conf), torch.from_numpy(loc), "torch"), torch.from_numpy(t))
    assert get_loss("SSDLoss", {"image_size": 320}).anchors.shape == (3234, 4)


GRID_64 = {"fig_size": 64, "feat_size": [4, 2, 1, 1, 1, 1], "scales": [6, 16, 27, 37, 47, 57, 67],
           "aspect_ratios": [[2, 3]] * 6}  # ANCHORS, as the model's arch_params
STEP_CASES = {  # recipe: (architecture, models.get kwargs, side, batch, port rules, JAX key mapper)
    "coco2017_ssd_lite_mobilenet_v2": ("ssd_lite_mobilenet_v2", dict(num_classes=80, image_size=64, arch_params={
        "heads": {"SSDHead": {"anchors": GRID_64}}}), 64, 2, from_jax.SSD_LITE_V2_RULES,
        tc.ssd_lite_mobilenet_v2_key_mapper),
    "imagenet_mobilenetv2": ("mobilenet_v2", dict(num_classes=10, arch_params={"width_mult": 0.5}), 64, 4,
                             from_jax.MOBILENET_V2_RULES, tc.mobilenet_v2_key_mapper),
    "imagenet_mobilenetv3_large": ("mobilenet_v3_large", dict(num_classes=10, arch_params={"width_mult": 0.5}), 64, 4,
                                   from_jax.MOBILENET_V3_RULES, tc.mobilenet_v3_key_mapper),
}
STEP_KEYS = ("loss", "criterion_params", "optimizer", "optimizer_params", "zero_weight_decay_on_bias_and_bn",
             "initial_lr")


def _step_targets(recipe, b):
    rng = np.random.RandomState(4)
    if not recipe.startswith("coco"):
        return rng.randint(0, 10, b)
    targets = -np.ones((b, 6, 5), np.float64)
    targets[0, :2] = [[3, 4, 6, 28, 40], [7, 30, 8, 60, 62]]
    targets[1, :1] = [[0, 12, 12, 24, 32]]
    return targets


def _check_one_step(recipe):
    """One step of ``recipe``'s criterion and optimizer (its loss, ``criterion_params``, SGD
    with its momentum and weight decay, the zero-decay mask, ``initial_lr``) on a train-mode
    forward, fp64 on both sides (dropout 0): the loss, every parameter's gradient and every
    parameter's move in the step, each within ``rtol=1e-6`` (atol 1e-6 of the tensor's largest
    magnitude, at least 1e-12)."""
    name, kw, side, b, rules, mapper = STEP_CASES[recipe]
    hp = {k: config.load_recipe(recipe)["training_hyperparams"].get(k) for k in STEP_KEYS}
    assert hp == {k: jax_config.load_recipe(recipe)["training_hyperparams"].get(k) for k in STEP_KEYS}
    assert hp["optimizer"] == "SGD" and hp["optimizer_params"]["momentum"] > 0
    if hp["loss"] == "SSDLoss":  # the 64 px model's grid in place of the recipe's 320 px one
        hp["criterion_params"] = dict(hp["criterion_params"], anchors_cxcywh=ANCHORS)
    pm = models.get(name, device="cpu", **kw)
    jm = jax_model(name, **kw)
    sd = {k: v.numpy() for k, v in pm.net.state_dict().items()}
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, tc.convert_state_dict(sd, jm.variables, mapper())))
    module = jm.module.clone(dropout=0.0) if hasattr(jm.module, "dropout") else jm.module
    x = np.random.RandomState(5).rand(b, side, side, 3)
    targets = _step_targets(recipe, b)
    v0 = jax.tree_util.tree_map(np.asarray, jax.device_get(jm.variables))
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v0)
        params = v64["params"]
        jloss = jax_get_loss(hp["loss"], hp["criterion_params"])

        def jax_loss(p):
            out, _ = module.apply({**v64, "params": p}, jnp.asarray(x), train=True, mutable=["batch_stats"])
            loss = jloss(out, jnp.asarray(targets))
            return loss[0] if isinstance(loss, tuple) else loss

        tx = jax_optimizers.build_optimizer(hp["optimizer"], params, lambda step: hp["initial_lr"],
                                            hp["optimizer_params"], hp["zero_weight_decay_on_bias_and_bn"])

        def jax_step(p):  # (loss, gradients, each parameter's move)
            value, grads = jax.value_and_grad(jax_loss)(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            return value, grads, jax.tree_util.tree_map(lambda new, old: new - old, optax.apply_updates(p, updates), p)

        jv, jgrads, moved = jax.tree_util.tree_map(
            np.asarray, jax.jit(jax_step, compiler_options=FP64_COMPILE)(params))
        jv = float(jv)

    net = pm.net.double().train()
    for m in net.modules():
        if isinstance(m, SeededDropout):
            m.p = 0.0
    start = {k: p.detach().clone() for k, p in net.named_parameters()}
    opt = build_optimizer(hp["optimizer"], net.named_parameters(), hp["optimizer_params"],
                          hp["zero_weight_decay_on_bias_and_bn"])
    for group in opt.param_groups:
        group["lr"] = hp["initial_lr"] * group["lr_mult"]
    loss = get_loss(hp["loss"], hp["criterion_params"])(net(torch.from_numpy(x).permute(0, 3, 1, 2)),
                                                        torch.from_numpy(targets))
    pv = loss[0] if isinstance(loss, tuple) else loss
    pv.backward()
    opt.step()
    np.testing.assert_allclose(pv.item(), jv, rtol=1e-6)
    jax_grads = variables_from_jax_to_torch({"params": jgrads}, rules)
    jax_moved = variables_from_jax_to_torch({"params": moved}, rules)
    named = dict(net.named_parameters())
    assert set(named) == set(jax_grads) == set(jax_moved)
    for k, p in named.items():
        for got, ref, what in ((p.grad, jax_grads[k], "gradient"), (p.detach() - start[k], jax_moved[k], "move")):
            r = ref.double().numpy()
            np.testing.assert_allclose(got.numpy(), r, rtol=1e-6, atol=max(1e-6 * np.abs(r).max(), 1e-12),
                                       err_msg=f"{k} {what}")
    # not vacuous: most leaves get a gradient above the noise floor (none in exact arithmetic
    # reaches a BN shift whose next layer is a 1x1 conv and a batch-statistics BN, nor SSD's
    # levels without a positive or a mined negative)
    assert sum(float(p.grad.abs().max()) > 1e-12 for p in named.values()) > 2 / 3 * len(named)


def test_one_step_of_the_ssd_recipe_criterion_matches_jax():
    _check_one_step("coco2017_ssd_lite_mobilenet_v2")


def test_one_step_of_the_mobilenet_recipe_criterion_matches_jax():
    _check_one_step("imagenet_mobilenetv2")


def test_one_step_of_the_mobilenet_v3_recipe_criterion_matches_jax():
    _check_one_step("imagenet_mobilenetv3_large")
