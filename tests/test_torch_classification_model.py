"""The ResNet family of the PyTorch port against the JAX package's, on the same weights.

The port model is built by ``models.get(..., device="cpu")`` (seeded random weights, BN
statistics calibrated on noise so that eval-mode activations stay near unit scale), and
its ``state_dict`` goes into the JAX model through the JAX package's own converter
(``torch_converter.convert_state_dict`` with ``resnet_key_mapper``). The other direction,
``conversion/from_jax.py`` with ``RESNET_RULES``, must give back the same tensors bit
for bit and load the JAX model's own initial parameters strictly.

Tolerances, on the CPU: eval-mode logits in fp32 at ``atol=1e-4, rtol=1e-4`` (the two
libraries' convolutions and means sum in other orders; the logits are O(1-10)). The
train-mode forward and the updated BN buffers are held in fp64 (``jax.enable_x64``) at
``rtol=1e-9``: flax's fp32 batch variance takes ``E[x^2] - E[x]^2``. The running
variance is torch's unbiased update and flax's biased one, mapped by
``c = n / (n - 1)`` as ``test_torch_train_step.py`` maps them.

Widths are cut (``width_mult`` 0.25) and the batch is 2-3; ``resnet18_cifar`` runs at its
full width at 32x32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from super_gradients_tpu import models as jax_models
from super_gradients_tpu.conversion.torch_converter import convert_state_dict, resnet_key_mapper
from super_gradients_tpu.models.classification.resnet import ResNet as JaxResNet
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import RESNET_RULES, variables_from_jax_to_torch
from super_gradients_tpu_torch.inference import processing as port_processing
from super_gradients_tpu_torch.inference.prediction_results import ClassificationPrediction
from super_gradients_tpu_torch.models.classification.resnet import ResNet
from super_gradients_tpu_torch.models.sg_model import ClassificationModel
from torch_jax_init import FP64_COMPILE, jax_model

torch.set_num_threads(2)
NARROW = {"width_mult": 0.25}
CASES = {  # name: (models.get kwargs, input size)
    "resnet18": (dict(num_classes=10, arch_params=NARROW), 64),
    "resnet50": (dict(num_classes=10, arch_params=NARROW), 64),
    "resnet18_cifar": (dict(num_classes=10), 32),
}


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def carried_pair(name, **kw):
    """(JAX model, port model on the CPU) carrying the port model's weights."""
    pm = models.get(name, device="cpu", **kw)
    jm = jax_model(name, **kw)
    sd = {k: v.numpy() for k, v in pm.net.state_dict().items()}
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, convert_state_dict(sd, jm.variables, resnet_key_mapper())))
    return jm, pm


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    kw, size = CASES[request.param]
    jm, pm = carried_pair(request.param, **kw)
    return request.param, jm, pm, size


def test_weights_carry_both_ways(pair):
    """JAX's tree of the port's weights converts back to the same tensors, bit for bit,
    and a JAX model's initial parameters (flax's default initializers over its traced init)
    load strictly into a fresh port net."""
    name, jm, pm, _ = pair
    back = variables_from_jax_to_torch(_numpy(jm.variables), RESNET_RULES)
    sd = pm.net.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    kw, _ = CASES[name]
    fresh = jax_model(name, **kw)
    net = models.get(name, device="cpu", **kw).net
    net.load_state_dict(variables_from_jax_to_torch(_numpy(fresh.variables), RESNET_RULES), strict=True)
    assert torch.equal(net.linear.weight, torch.from_numpy(np.asarray(fresh.params["linear"]["kernel"]).T.copy()))


def test_forward_eval_matches_jax(pair):
    name, jm, pm, size = pair
    x = np.random.RandomState(1).randn(3, size, size, 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jm.module.apply(v, x, train=False))(jm.variables, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == ref.shape == (3, 10) and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def _bn_inputs_per_channel(net, x):
    sizes = {}
    hooks = [m.register_forward_pre_hook(lambda mod, inp, n=n: sizes.__setitem__(n, inp[0].numel() // inp[0].shape[1]))
             for n, m in net.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    return sizes


def test_forward_train_mode_bn_matches_jax_in_fp64(pair):
    """Batch-statistics BN: logits, running means and (mapped) running variances."""
    name, jm, pm, size = pair
    x = np.random.RandomState(2).randn(2, size, size, 3)
    v0 = _numpy(jm.variables)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v0)
        out, mutated = jax.jit(lambda v, x: jm.module.apply(v, x, train=True, mutable=["batch_stats"]),
                               compiler_options=FP64_COMPILE)(v64, jnp.asarray(x))
        ref = np.asarray(out)
        new_stats = _numpy(mutated["batch_stats"])
    net = models.get(name, device="cpu", **CASES[name][0]).net
    net.load_state_dict(pm.net.state_dict())
    net = net.double().eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    sizes = _bn_inputs_per_channel(net, xt)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    net.train()
    with torch.no_grad():
        got = net(xt).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
    jax_sd = variables_from_jax_to_torch({"params": v0["params"], "batch_stats": new_stats}, RESNET_RULES)
    after = net.state_dict()
    checked = 0
    for key in (k for k in after if k.endswith("running_var")):
        prefix = key[: -len(".running_var")]
        c = sizes[prefix] / (sizes[prefix] - 1)
        old = before[key]
        expected = 0.9 * old + c * (jax_sd[key].double() - 0.9 * old)
        torch.testing.assert_close(after[key], expected, rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(after[prefix + ".running_mean"], jax_sd[prefix + ".running_mean"].double(),
                                   rtol=1e-9, atol=1e-12)
        checked += 1
    assert checked == sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())


def test_bottleneck_backbone_mode_and_expansion_match_jax():
    """``backbone_mode`` (pooled features, no ``linear``) and a bottleneck expansion of 2,
    module against module; the shortcuts exist exactly where stride or width change."""
    kw = dict(num_blocks=(1, 2, 1, 1), block="bottleneck", width_mult=0.25, expansion=2, backbone_mode=True)
    jmod = JaxResNet(**kw)
    x = np.random.RandomState(3).randn(2, 48, 48, 3).astype(np.float32)
    variables = _numpy(jax.jit(jmod.init, static_argnames="train")(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    rng = np.random.RandomState(4)
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables["batch_stats"])[0]:
        leaf[...] = rng.rand(*leaf.shape) + (0.5 if path[-1].key == "var" else -0.5)
    net = ResNet(**kw)
    assert not hasattr(net, "linear")
    net.load_state_dict(variables_from_jax_to_torch(variables, RESNET_RULES), strict=True)
    shortcuts = [n for n, m in net.named_modules() if n.endswith("shortcut") and len(m)]
    assert shortcuts == ["layer1.0.shortcut", "layer2.0.shortcut", "layer3.0.shortcut", "layer4.0.shortcut"]
    assert len(net.layer2[1].shortcut) == 0
    ref = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x), train=False))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == ref.shape == (2, 128 * 2)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_stem_max_pool_pads_with_minus_inf():
    """On inputs that are all negative, a zero-padded pool would differ at the border."""
    x = -1.0 - np.random.RandomState(5).rand(2, 9, 11, 4).astype(np.float32)
    padded = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-jnp.inf)
    import flax.linen as nn

    ref = np.asarray(nn.max_pool(padded, (3, 3), strides=(2, 2)))
    got = ResNet((1, 1, 1, 1)).maxpool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 5, 6, 4)
    np.testing.assert_array_equal(got, ref)
    assert (got < -1.0).all()


@pytest.mark.parametrize("name,expected_params", [
    ("resnet18", 11_689_512), ("resnet34", 21_797_672), ("resnet50", 25_557_032), ("resnet101", 44_549_160),
    ("resnet152", 60_192_808), ("resnet18_cifar", 11_173_962)])
def test_zoo_registers_the_family(name, expected_params):
    """Every name builds a ClassificationModel at the JAX spec's size and class count (the
    published ResNet parameter counts); the GPU default raises without a GPU."""
    model = models.get(name, device="cpu")
    assert isinstance(model, ClassificationModel) and model.task == "classification"
    assert sum(p.numel() for p in model.net.parameters()) == expected_params
    jspec = jax_models.get_architecture(name)(num_classes=None, arch_params={})
    assert model.num_classes == jspec.num_classes and model.net.linear.out_features == jspec.num_classes
    assert (model._processing is None) == (jspec.processing is None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.get(name)


# ------------------------------------------------------------------ predict


def _request(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,), dtype=np.uint8) for hw in ((300, 400), (256, 256), (480, 270), (230, 600))]


@pytest.fixture(scope="module")
def predict_pair():
    return carried_pair("resnet18", num_classes=10, arch_params=NARROW)


def test_predict_processing_byte_equal_to_jax_with_cv2(predict_pair):
    jm, pm = predict_pair
    images = _request(6)
    _, jax_batches, _ = jm._prep_host_batches(images, 3)
    _, port_batches, _ = pm._prep_host_batches(images, 3, pad_last=True)
    assert len(port_batches) == len(jax_batches) == 2
    for (jb, _), pb in zip(jax_batches, port_batches):
        assert pb.shape == (3, 224, 224, 3) and pb.dtype == np.float32
        np.testing.assert_array_equal(pb, jb)


@pytest.mark.parametrize("batch_size", [2, 3, 32])
def test_predict_matches_jax(predict_pair, batch_size):
    """Top-5 labels equal, confidences within 1e-5, on mixed-size uint8 images."""
    jm, pm = predict_pair
    images = _request(7)
    ref = jm.predict(images, batch_size=batch_size)
    got = pm.predict(images, batch_size=batch_size)
    assert len(got) == len(ref) == 4
    for g, r, img in zip(got, ref, images):
        assert isinstance(g, ClassificationPrediction) and g.image is img
        np.testing.assert_array_equal(g.labels, r.labels)
        np.testing.assert_allclose(g.confidence, r.confidence, atol=1e-5, rtol=0)
        assert g.prediction == r.prediction == int(g.labels[0]) and len(g.labels) == 5


def test_predict_top_k_and_one_image(predict_pair):
    jm, pm = predict_pair
    image = _request(8)[2]
    got, ref = pm.predict(image, top_k=10)[0], jm.predict(image, top_k=10)[0]
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert sorted(got.labels.tolist()) == list(range(10))
    np.testing.assert_allclose(got.confidence.sum(), 1.0, rtol=1e-5)


@pytest.fixture
def no_cv2(monkeypatch):
    """The port's no-cv2 path: its cv2 getter returns None (the JAX package keeps cv2)."""
    monkeypatch.setattr(port_processing, "cv2_module", lambda: None)


def test_no_cv2_resize_within_one_grey_level(no_cv2):
    from super_gradients_tpu.inference import processing as jax_processing

    for image in _request(9):
        for jax_step, port_step in (
            (jax_processing.ClassificationResizeShortestCrop(256, 224), port_processing.ClassificationResizeShortestCrop(256, 224)),
            (jax_processing.Resize(256), port_processing.Resize(256)),
            (jax_processing.ClassificationResize(64), port_processing.ClassificationResize(64)),
        ):
            ref, _ = jax_step.preprocess_image(image)
            got, _ = port_step.preprocess_image(image)
            assert got.shape == ref.shape and got.dtype == np.uint8
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("which", ["default_imagenet_processing", "default_imagenet_processing_params"])
def test_imagenet_processings_byte_equal_to_jax(which):
    """Both ImageNet compositions; ``Resize`` truncates the new sides, the shortest-crop
    step rounds them (a 300x401 image tells them apart)."""
    from super_gradients_tpu.inference import processing as jax_processing

    def build(module):
        out = getattr(module, which)()
        return out["image_processor"] if isinstance(out, dict) else out

    image = np.random.RandomState(10).randint(0, 256, (300, 401, 3), dtype=np.uint8)
    ref, _ = build(jax_processing).preprocess_image(image)
    got, _ = build(port_processing).preprocess_image(image)
    assert got.shape == ref.shape == (224, 224, 3)
    np.testing.assert_array_equal(got, ref)
    assert port_processing.Resize(256).preprocess_image(image)[0].shape[1] == int(401 * 256 / 300)
    assert port_processing.ClassificationResizeShortestCrop(256, 300).preprocess_image(image)[0].shape[1] == 300
    assert jax_processing.Resize(256).preprocess_image(image)[0].shape[1] == 342


def test_predict_files_folders_and_pil(predict_pair, tmp_path):
    from PIL import Image

    jm, pm = predict_pair
    images = _request(11)
    for i, img in enumerate(images[:2]):
        Image.fromarray(img).save(tmp_path / f"{i}.png")
    got = pm.predict(str(tmp_path))
    ref = jm.predict(str(tmp_path))
    assert len(got) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.labels, r.labels)
    pil = pm.predict(Image.fromarray(images[0]))[0]
    np.testing.assert_array_equal(pil.labels, got[0].labels)
    np.testing.assert_allclose(pil.confidence, got[0].confidence, rtol=0, atol=0)


def test_softmax_on_device_argsort_on_host(predict_pair):
    """The probabilities are the softmax of the eval-mode fp32 logits of the padded batch."""
    _, pm = predict_pair
    images = _request(12)[:3]
    _, batches, _ = pm._prep_host_batches(images, 4, pad_last=True)
    assert (batches[0][3] == 0).all()
    with torch.no_grad():
        logits = pm.net.eval()(torch.from_numpy(batches[0]).permute(0, 3, 1, 2))
    probs = F.softmax(logits, dim=-1).numpy()
    preds = pm.predict(images, batch_size=4)
    for j, p in enumerate(preds):
        order = np.argsort(-probs[j])[:5]
        np.testing.assert_array_equal(p.labels, order)
        np.testing.assert_array_equal(p.confidence, probs[j][order])
