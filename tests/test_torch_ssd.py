"""SSD-lite-MobileNetV2 and SSD-MobileNetV1 of the PyTorch port against the JAX package's.

The port model is built by ``models.get(..., device="cpu")`` and its ``state_dict`` goes into
the JAX model through the JAX converter (``ssd_*_key_mapper``); ``SSD_*_RULES`` of
``conversion/from_jax.py`` load the JAX model's own variables strictly. SSD-lite runs at 64
px through an ``arch_params`` anchor grid (``heads.SSDHead.anchors``: feature sizes 4, 2, 1,
1, 1, 1, 144 anchors) and SSD-V1 at 320 (its neck needs ~256 px to keep its last map at
2x2), both with 4 classes.

Tolerances, on the CPU (BN statistics set on 16 noise images, see :func:`carried_pair`):
eval-mode ``cls_logits`` / ``reg_distri`` (O(1-10)) at ``atol=5e-4, rtol=1e-4``,
``pred_scores`` at ``atol=1e-4`` and the decoded boxes at ``atol=5e-3`` px, ``rtol=1e-4``
(``exp`` of the locs times anchors of up to 336 px); the train-mode forward as
:func:`test_forward_train_mode_matches_jax` states; ``generate_ssd_anchors`` exactly;
``predict()`` through K1's plain version against JAX ``predict(nms_mode="exact")`` in fp32:
equal counts and >= 99% of the detections matched one to one (:func:`matched_fraction`).

The JAX predict program suppresses on the sigmoid of the raw ``[B, A, C + 1]`` confs,
background column included (``YoloNASOutputs`` takes the logits path), so every label is
shifted by one and a label can equal ``num_classes``: a fault of the JAX package, kept by
the port and pinned here in both (ROADMAP.md section 3).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu.models.detection import ssd as jax_ssd
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion import from_jax
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.models.detection import ssd
from super_gradients_tpu_torch.models.model_factory import _calibrate_batch_norm
from torch_jax_init import FP64_COMPILE, jax_model

torch.set_num_threads(2)
NUM_CLASSES = 4
GRID_64 = {"fig_size": 64, "feat_size": [4, 2, 1, 1, 1, 1], "scales": [6, 16, 27, 37, 47, 57, 67],
           "aspect_ratios": [[2, 3]] * 6}
LITE_AP = {"heads": {"SSDHead": {"anchors": GRID_64}}}
CASES = {  # name: (architecture, models.get kwargs, side, port rules, JAX key mapper)
    "lite": ("ssd_lite_mobilenet_v2", dict(num_classes=NUM_CLASSES, image_size=64, arch_params=LITE_AP), 64,
             from_jax.SSD_LITE_V2_RULES, tc.ssd_lite_mobilenet_v2_key_mapper),
    "v1": ("ssd_mobilenet_v1", dict(num_classes=NUM_CLASSES, image_size=320), 320, from_jax.SSD_V1_RULES,
           tc.ssd_mobilenet_v1_key_mapper),
}
FIELDS = ("cls_logits", "reg_distri", "pred_scores", "pred_bboxes")


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def carried_pair(case):
    """(JAX model, port model on the CPU) carrying the port model's weights, whose BN
    statistics are set on 16 noise images: the lite heads' BNs on the neck's 1x1 maps would
    see only two values a channel in ``models.get``'s two-image calibration, and amplify the
    two libraries' rounding past any fixed tolerance."""
    name, kw, side, _, mapper = CASES[case]
    pm = models.get(name, device="cpu", **kw)
    _calibrate_batch_norm(pm.net, torch.Generator().manual_seed(3), (16, 3, side, side))
    jm = jax_model(name, **kw)
    sd = {k: v.numpy() for k, v in pm.net.state_dict().items()}
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, tc.convert_state_dict(sd, jm.variables, mapper())))
    return jm, pm


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    jm, pm = carried_pair(request.param)
    return request.param, jm, pm


@pytest.fixture(scope="module")
def lite():
    return carried_pair("lite")


@pytest.mark.parametrize("grid", ["lite_v2", "v1", "lite_64", "lite_v2_512"])
def test_anchors_equal_jax(grid):
    kw = {"lite_v2": {}, "v1": dict(feat_sizes=ssd._V1_FEAT, scales=ssd._V1_SCALES, aspect_ratios=ssd._V1_ARS),
          "lite_64": dict(fig_size=64, feat_sizes=(4, 2, 1, 1, 1, 1), scales=tuple(GRID_64["scales"])),
          "lite_v2_512": dict(fig_size=512)}[grid]
    got, ref = ssd.generate_ssd_anchors(**kw), jax_ssd.generate_ssd_anchors(**kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert got.min() >= 0 and got.max() <= kw.get("fig_size", 320)


def test_model_sizes_and_anchor_counts():
    """The registered sizes: 3,234 anchors for SSD-lite at 320, 9,602 for SSD-V1; the config
    that an arch_params anchor tree gives equals the JAX builder's."""
    for name, count in (("ssd_lite_mobilenet_v2", 3234), ("ssd_mobilenet_v1", 9602)):
        spec = models.model_factory.get_architecture(name)()
        assert len(spec.net._anchors) == count and spec.input_hw == (320, 320) and spec.num_classes == 80
    _, kw, _, _, _ = CASES["lite"]
    jspec = jax_models.model_factory.get_architecture("ssd_lite_mobilenet_v2")(**kw)
    pspec = models.model_factory.get_architecture("ssd_lite_mobilenet_v2")(**kw)
    assert dataclasses_equal(pspec.config, jspec.config)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_weights_carry_both_ways(pair):
    case, jm, pm = pair
    name, kw, _, rules, _ = CASES[case]
    back = variables_from_jax_to_torch(numpy_tree(jm.variables), rules)
    sd = pm.net.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    models.get(name, device="cpu", seed=1, **kw).net.load_state_dict(back, strict=True)
    assert pm.num_params() == jm.num_params()


def test_forward_eval_matches_jax(pair):
    case, jm, pm = pair
    side = CASES[case][2]
    x = np.random.RandomState(1).rand(2, side, side, 3).astype(np.float32)
    ref = jax.jit(functools.partial(jm.module.apply, train=False))(jm.variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm.net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.cls_logits.shape[-1] == NUM_CLASSES + 1 and got.pred_scores.shape[-1] == NUM_CLASSES
    assert got.num_anchors_list == ref.num_anchors_list
    tol = {"cls_logits": (5e-4, 1e-4), "reg_distri": (5e-4, 1e-4), "pred_scores": (1e-4, 0), "pred_bboxes": (5e-3, 1e-4)}
    for field in FIELDS:
        g, r = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert g.dtype == np.float32 and g.shape == r.shape, field
        np.testing.assert_allclose(g, r, atol=tol[field][0], rtol=tol[field][1], err_msg=field)
    np.testing.assert_array_equal(got.anchor_points.numpy(), np.asarray(ref.anchor_points))


def test_forward_train_mode_matches_jax(pair):
    """Batch-statistics BN, the updated BN means included. SSD-lite at 64 px (its head BNs
    normalize two values a channel on the neck's 1x1 maps, ill-conditioned in fp32) in fp64
    on both sides (``jax.enable_x64``), whose decodes cast to fp32: every output within 1e-6.
    SSD-V1 at 320 in fp32 (an fp64 JAX compile of it takes a minute), both packages held to
    an fp64 run of the port: each output within 5e-4 of its scale (measured: JAX 4e-5, the
    port 2e-4 of the logits' scale), the updated BN means within 1e-3."""
    case, jm, pm = pair
    name, kw, side, rules, _ = CASES[case]
    v0 = numpy_tree(jm.variables)
    net = models.get(name, device="cpu", **kw).net
    net.load_state_dict(pm.net.state_dict())
    apply = jax.jit(functools.partial(jm.module.apply, train=True, mutable=["batch_stats"]))
    if case == "lite":
        x = np.random.RandomState(2).rand(2, side, side, 3)
        with jax.enable_x64():
            apply64 = jax.jit(functools.partial(jm.module.apply, train=True, mutable=["batch_stats"]),
                              compiler_options=FP64_COMPILE)
            out, mutated = apply64(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v0), jnp.asarray(x))
        net = net.double().train()
        with torch.no_grad():
            got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
        for field in FIELDS:  # the JAX fp64 scales promote the boxes back to fp64
            g = getattr(got, field).numpy()
            assert g.dtype == np.float32, field
            np.testing.assert_allclose(g, np.asarray(getattr(out, field)), rtol=1e-6,
                                       atol=1e-6 if field != "pred_bboxes" else 1e-4, err_msg=field)
        mean_tol = dict(rtol=1e-9, atol=1e-12)
    else:
        x = np.random.RandomState(2).rand(2, side, side, 3).astype(np.float32)
        out, mutated = apply(jm.variables, jnp.asarray(x))
        net64 = copy.deepcopy(net).double().train()
        net.train()
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        with torch.no_grad():
            got, ref64 = net(xt), net64(xt.double())
        for field in FIELDS:
            g, r = getattr(got, field).double().numpy(), getattr(ref64, field).double().numpy()
            scale = np.abs(r).max()
            e_port, e_jax = np.abs(g - r).max(), np.abs(np.asarray(getattr(out, field), np.float64) - r).max()
            assert max(e_jax, e_port) <= 5e-4 * scale, (field, e_port, e_jax, scale)
        mean_tol = dict(rtol=1e-3, atol=1e-4)
    stats = numpy_tree(mutated["batch_stats"])
    jax_sd = variables_from_jax_to_torch({"params": v0["params"], "batch_stats": stats}, rules)
    means = [k for k in jax_sd if k.endswith("running_mean")]
    assert len(means) == sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    for key in means:
        torch.testing.assert_close(net.state_dict()[key], jax_sd[key].to(net.state_dict()[key].dtype), **mean_tol)


def _images():
    rng = np.random.RandomState(5)
    return [rng.randint(0, 256, (48, 64, 3), dtype=np.uint8), rng.randint(0, 256, (64, 40, 3), dtype=np.uint8)]


def matched_fraction(g, r, box_tol=1e-2, score_tol=1e-4):
    """Share of the detections matched one to one across the two packages: the same label,
    every box coordinate within ``box_tol`` px (boxes clipped to the image can have no area)
    and scores within ``score_tol`` (rank swaps among near-equal scores reorder the lists)."""
    rb, rl, rs = np.asarray(r.bboxes_xyxy), np.asarray(r.labels), np.asarray(r.confidence)
    if len(g) != len(r):
        return 0.0
    if not len(g):
        return 1.0
    ok = np.abs(g.bboxes_xyxy[:, None] - rb[None]).max(-1) <= box_tol
    ok &= (g.labels[:, None] == rl[None]) & (np.abs(g.confidence[:, None] - rs[None]) <= score_tol)
    used, n = set(), 0
    for i in range(len(g)):
        for j in np.flatnonzero(ok[i]):
            if j not in used:
                used.add(j)
                n += 1
                break
    return n / len(g)


def test_predict_matches_jax(lite):
    """``predict()`` through K1's plain version against JAX ``predict(nms_mode="exact")``, fp32:
    equal counts, at least 99% of the detections matched one to one."""
    jm, pm = lite
    kw = dict(conf=0.3, nms_mode="exact", bf16=False, batch_size=2, max_predictions=1000)
    got, ref = pm.predict(_images(), **kw), jm.predict(_images(), **kw)
    assert sum(len(g) for g in got) > 0
    for g, r in zip(got, ref):
        assert matched_fraction(g, r) >= 0.99


def test_predict_keeps_the_jax_background_column(lite):
    """At ``conf=0.0`` both packages return the same detections (>= 99% matched one to one,
    label for label), and some label equals ``num_classes``: the sigmoid of the raw confs,
    background column 0 included, shifts every class by one. Drawing such a label with the
    model's class names attached raises the same ``IndexError`` in both."""
    jm, pm = lite
    kw = dict(conf=0.0, nms_mode="exact", bf16=False, batch_size=2, max_predictions=1000)
    got, ref = pm.predict(_images(), **kw), jm.predict(_images(), **kw)
    for g, r in zip(got, ref):
        assert len(g) > 0 and matched_fraction(g, r) >= 0.99
        assert np.asarray(r.labels).max() == NUM_CLASSES
    labels = np.concatenate([g.labels for g in got])
    assert labels.max() == NUM_CLASSES and labels.min() >= 0
    names = ["a", "b", "c", "d"]
    for model in (pm, jm):
        model.set_dataset_processing_params(class_names=names)
    try:
        for preds in (pm.predict(_images(), **kw), jm.predict(_images(), **kw)):
            with pytest.raises(IndexError):
                for p in preds:
                    p.draw()
    finally:
        for model in (pm, jm):
            model._class_names = None
