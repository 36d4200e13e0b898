"""Classification losses and metrics of the PyTorch port against the JAX package's.

Losses: logits ``[6, 7]`` made with numpy from a seed, int labels (one out of range,
which ``jax.nn.one_hot`` makes a row of zeros), one-hot and soft targets; the value and
its gradient with respect to the logits (``jax.grad`` against autograd), fp32 on the
CPU, within ``atol=1e-6`` (``rtol=1e-6`` for the value). Metrics: ``Accuracy`` and
``Top5`` accumulated over several batches, equal to JAX's, with batches of tied logits
(Top5's stable sort ranks equal logits by the lowest class index, as ``jnp.argsort``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_gradients_tpu.training.losses import classification_losses as jax_losses
from super_gradients_tpu.training.metrics import classification as jax_metrics
from super_gradients_tpu_torch.training.losses import get_loss
from super_gradients_tpu_torch.training.metrics import MetricCollection, get_metric
from super_gradients_tpu_torch.training.metrics import classification as port_metrics

B, C = 6, 7


def _targets(kind, rng):
    labels = rng.randint(0, C, B)
    if kind == "int":
        return labels.astype(np.int32)
    if kind == "int_out_of_range":
        labels[2] = -1
        return labels.astype(np.int32)
    if kind == "onehot":
        return np.eye(C, dtype=np.float32)[labels]
    soft = rng.rand(B, C).astype(np.float32)
    return soft / soft.sum(-1, keepdims=True)


LOSSES = {
    "CrossEntropyLoss": {},
    "CrossEntropyLoss-smoothing": {"label_smoothing": 0.1},
    "CrossEntropyLoss-smooth_eps": {"label_smoothing": 0.3, "smooth_eps": 0.2},
    "LabelSmoothingCrossEntropyLoss": {},
    "LabelSmoothingCrossEntropyLoss-0.25": {"smooth_eps": 0.25},
    "FocalLoss": {},
    "FocalLoss-alpha-gamma": {"alpha": 0.5, "gamma": 1.5},
}
JAX_LOSSES = {"CrossEntropyLoss": jax_losses.CrossEntropyLoss, "FocalLoss": jax_losses.FocalLoss,
              "LabelSmoothingCrossEntropyLoss": jax_losses.LabelSmoothingCrossEntropyLoss}


@pytest.mark.parametrize("kind", ["int", "int_out_of_range", "onehot", "soft"])
@pytest.mark.parametrize("case", list(LOSSES))
def test_classification_loss_and_gradient_match_jax(case, kind):
    name, params = case.split("-")[0], LOSSES[case]
    rng = np.random.RandomState(10 * list(LOSSES).index(case) + len(kind))
    logits = (rng.randn(B, C) * 3).astype(np.float32)
    targets = _targets(kind, rng)
    jax_loss = JAX_LOSSES[name](**params)

    def f(x):
        return jax_loss(x, jnp.asarray(targets))

    (ref, ref_aux), ref_grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss, aux = get_loss(name, params)(x, torch.from_numpy(targets))
    loss.backward()
    assert set(aux) == set(ref_aux) == {name if name != "LabelSmoothingCrossEntropyLoss" else "CrossEntropyLoss"}
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,jax_cls,out_shape,target_shape", [
    ("MSE", jax_losses.MSELoss, (B, 1), (B,)), ("MSE", jax_losses.MSELoss, (B, 3), (B, 3)),
    ("RSquaredLoss", jax_losses.RSquaredLoss, (B, 1), (B,)), ("RSquaredLoss", jax_losses.RSquaredLoss, (B,), (B,))])
def test_regression_losses_match_jax(name, jax_cls, out_shape, target_shape):
    """The targets are reshaped to the outputs (MSE) or the outputs to the targets (R^2)."""
    rng = np.random.RandomState(sum(out_shape))
    outputs = rng.randn(*out_shape).astype(np.float32)
    targets = rng.randn(*target_shape).astype(np.float32)

    def f(x):
        return jax_cls()(x, jnp.asarray(targets))

    (ref, _), ref_grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(outputs))
    x = torch.from_numpy(outputs).requires_grad_()
    loss, aux = get_loss(name)(x, torch.from_numpy(targets))
    loss.backward()
    assert list(aux) == [name]
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), atol=1e-6, rtol=1e-5)


def test_smoothing_is_optax_formula_not_torch_label_smoothing():
    """optax smooths one-hot rows as ``onehot * (1 - eps) + eps / C``; on a soft target
    ``F.cross_entropy(label_smoothing=)`` would smooth differently."""
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(B, C).astype(np.float32))
    soft = torch.from_numpy(_targets("soft", rng))
    loss, _ = get_loss("CrossEntropyLoss", {"label_smoothing": 0.2})(logits, soft)
    expected = -((soft * 0.8 + 0.2 / C) * torch.log_softmax(logits, -1)).sum(-1).mean()
    torch.testing.assert_close(loss, expected, rtol=0, atol=0)


def _metric_batches():
    rng = np.random.RandomState(2)
    batches = []
    for i in range(4):
        logits = rng.randn(B, C).astype(np.float32)
        labels = rng.randint(0, C, B).astype(np.int32)
        batches.append((logits, labels))
    tied = np.zeros((B, C), np.float32)  # every logit equal: the first classes rank first
    tied[1, 3:] = 1.0  # ties among the top: 3..6 at 1, then 0..2 at 0
    tied[2, ::2] = 2.0
    batches.append((tied, np.array([0, 5, 6, 4, 1, 6], np.int32)))
    batches.append((tied, np.array([5, 2, 1, 3, 6, 0], np.int32)))
    return batches


@pytest.mark.parametrize("onehot", [False, True], ids=["int", "onehot"])
@pytest.mark.parametrize("name", ["Accuracy", "Top5"])
def test_metrics_over_batches_match_jax(name, onehot):
    jm = getattr(jax_metrics, name)()
    pm = get_metric(name)
    js, ps = jm.init(), pm.init()
    for logits, labels in _metric_batches():
        targets = np.eye(C, dtype=np.float32)[labels] if onehot else labels
        js = jm.update(js, jnp.asarray(logits), jnp.asarray(targets))
        ps = pm.update(ps, torch.from_numpy(logits), torch.from_numpy(targets))
    ref, got = jm.compute(js), pm.compute(ps)
    assert got == ref and 0.0 < got[name] < 1.0


def test_top5_ties_take_the_lowest_class_index():
    metric = port_metrics.Top5()
    tied = torch.zeros(3, C)
    tied[1, 3:] = 1.0
    hit = metric.compute(metric.update(metric.init(), tied, torch.tensor([4, 3, 4])))["Top5"]
    miss = metric.compute(metric.update(metric.init(), tied, torch.tensor([5, 1, 6])))["Top5"]
    assert hit == 1.0 and miss == 0.0  # row 1 keeps 3..6 and class 0; rows 0 and 2 keep 0..4


def test_metric_collection_and_toy_metric():
    coll = MetricCollection([get_metric("Accuracy"), get_metric("Top5"), get_metric("ToyTestClassificationMetric")])
    assert not coll.has_host_metrics()
    states = coll.init()
    for logits, labels in _metric_batches()[:2]:
        states = coll.update_device(states, torch.from_numpy(logits), torch.from_numpy(labels))
    out = coll.compute(states)
    assert set(out) == {"Accuracy", "Top5", "ToyTestClassificationMetric"} and out["ToyTestClassificationMetric"] == 0.0
    assert isinstance(states[0]["correct"], torch.Tensor) and states[0]["total"] == 2 * B
