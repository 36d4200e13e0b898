"""RMSProp and Lion of the port against the JAX package's optax transforms, on identical gradients.

Conv-, linear- and BN-shaped fp64 tensors take 5 steps of the same numpy-made gradients on both
sides: the port's ``build_optimizer`` (its LR set each step as the trainer sets it), the JAX
package's ``build_optimizer`` (``optax.rmsprop`` after the masked ``add_decayed_weights``, and
``optax.lion`` with its mask) under ``jax.enable_x64``, the LR a schedule over the step count. The
LR changes every step (0.1, 0.05, 0.2, 0.01, 0.3 for RMSProp; a tenth of them for Lion), which is
what tells optax's LR inside the RMSProp momentum trace apart from ``torch.optim.RMSprop``'s LR
outside it. Weight decay is masked off the 1-D tensors (``zero_weight_decay_on_bias_and_bn``) or
applied to all. Parameters and optimizer states after the last step: ``rtol = atol = 1e-12``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from super_gradients_tpu.training import optimizers as jax_optimizers
from super_gradients_tpu_torch.training.optimizers import Lion, RMSProp, build_optimizer

SHAPES = {"conv_weight": (4, 3, 3, 3), "bn_weight": (4,), "bn_bias": (4,), "linear_weight": (5, 4), "linear_bias": (5,)}
LRS = (0.1, 0.05, 0.2, 0.01, 0.3)
TOL = 1e-12

CASES = {
    "rmsprop_masked_decay": ("RMSProp", {"momentum": 0.9, "weight_decay": 1e-4}, True, 1.0),
    "rmsprop_recipe_spelling_decay_on_all": ("RMSprop", {"momentum": 0.9, "weight_decay": 1e-5, "decay": 0.95,
                                                         "eps": 1e-3}, False, 1.0),
    "rmsprop_no_momentum": ("rmsprop", {"momentum": 0.0}, True, 1.0),
    "lion_masked_decay": ("Lion", {"weight_decay": 0.1}, True, 0.1),
    "lion_decay_on_all": ("Lion", {"weight_decay": 0.05, "b1": 0.8, "b2": 0.9}, False, 0.1),
}


def _values(seed):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s) for n, s in SHAPES.items()}


def _grads():
    rng = np.random.RandomState(100)
    return [{n: rng.randn(*s) * scale for n, s in SHAPES.items()} for scale in (0.05, 3.0, 0.1, 6.0, 0.5)]


def port_run(name, params, zero_wd, lr_scale, lrs=LRS):
    tensors = {n: nn.Parameter(torch.from_numpy(v.copy())) for n, v in _values(0).items()}
    opt = build_optimizer(name, list(tensors.items()), params, zero_weight_decay_on_bias_and_bn=zero_wd)
    for lr, grads in zip(lrs, _grads()):
        for group in opt.param_groups:
            group["lr"] = lr * lr_scale * group["lr_mult"]
        for n, g in grads.items():
            tensors[n].grad = torch.from_numpy(g.copy())
        opt.step()
    return opt, tensors


def jax_run(name, params, zero_wd, lr_scale):
    with jax.enable_x64():
        values = jax.tree_util.tree_map(jnp.asarray, _values(0))
        lrs = jnp.asarray(LRS, jnp.float64) * lr_scale
        tx = jax_optimizers.build_optimizer(name, values, lambda count: lrs[count], params, zero_wd)
        state = tx.init(values)
        for grads in _grads():
            updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, values)
            values = jax.tree_util.tree_map(lambda p, u: p + u, values, updates)
        return {n: np.asarray(v) for n, v in values.items()}, jax.tree_util.tree_map(np.asarray, state)


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_optax_in_fp64(case):
    name, params, zero_wd, lr_scale = CASES[case]
    opt, tensors = port_run(name, params, zero_wd, lr_scale)
    got = {n: t.detach().numpy() for n, t in tensors.items()}
    ref, _ = jax_run(name, params, zero_wd, lr_scale)
    assert isinstance(opt, Lion if name == "Lion" else RMSProp)
    initial = _values(0)
    for n in SHAPES:
        assert np.abs(got[n] - initial[n]).max() > 1e-3, n
        np.testing.assert_allclose(got[n], ref[n], rtol=TOL, atol=TOL, err_msg=n)


def _find_state(tree, field):
    """The one optax state (a NamedTuple) in ``tree`` that has ``field``."""
    has = lambda x: field in getattr(x, "_fields", ())  # noqa: E731
    states = [s for s in jax.tree_util.tree_leaves(tree, is_leaf=has) if has(s)]
    assert len(states) == 1
    return getattr(states[0], field)


@pytest.mark.parametrize("case", ["rmsprop_masked_decay", "lion_masked_decay"])
def test_optimizer_state_matches_optax(case):
    """RMSProp's ``nu`` and momentum trace (the trace holds the LR-scaled updates, optax's with the
    sign flipped), Lion's ``mu``."""
    name, params, zero_wd, lr_scale = CASES[case]
    opt, tensors = port_run(name, params, zero_wd, lr_scale)
    _, state = jax_run(name, params, zero_wd, lr_scale)
    for n, p in tensors.items():
        if name == "Lion":
            np.testing.assert_allclose(opt.state[p]["mu"].numpy(), _find_state(state, "mu")[n], rtol=TOL, atol=TOL)
        else:
            np.testing.assert_allclose(opt.state[p]["nu"].numpy(), _find_state(state, "nu")[n], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(opt.state[p]["trace"].numpy(), -_find_state(state, "trace")[n], rtol=TOL,
                                       atol=TOL)


def test_lr_inside_the_trace_is_what_the_test_tells_apart():
    """``torch.optim.RMSprop``'s form (eps outside the root, the LR applied after the momentum
    buffer) lands > 1e-4 away from optax on these gradients and LRs, so the fp64 test above would
    catch it."""
    name, params, zero_wd, lr_scale = CASES["rmsprop_masked_decay"]
    ref, _ = jax_run(name, params, zero_wd, lr_scale)
    tensors = {n: nn.Parameter(torch.from_numpy(v.copy())) for n, v in _values(0).items()}
    opt = torch.optim.RMSprop([{"params": [t], "weight_decay": 1e-4 if t.ndim >= 2 else 0.0} for t in tensors.values()],
                              lr=0.1, alpha=0.9, eps=1e-8, momentum=0.9)
    for lr, grads in zip(LRS, _grads()):
        for group in opt.param_groups:
            group["lr"] = lr
        for n, g in grads.items():
            tensors[n].grad = torch.from_numpy(g.copy())
        opt.step()
    worst = max(float(np.abs(t.detach().numpy() - ref[n]).max()) for n, t in tensors.items())
    assert worst > 1e-4
