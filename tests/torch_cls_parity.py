"""Shared parity helpers of the classification-zoo tests (``test_torch_cls_zoo_*.py``): one
family at a cut size, the JAX module and the port net on the same weights.

:func:`run_family` draws the JAX variables from a numpy seed (``torch_seg_parity.seeded_variables``:
He-normal kernels, BN means near 0 and variances in [0.5, 1.5], LayerNorm scales near 1, small
biases, class tokens, position embeddings, LayerScales and bias tables), loads them into the port
net strictly through ``conversion/from_jax.py`` and runs:

- the eval-mode forward of both packages in fp32 on one seeded batch (the JAX module under
  ``jax.jit``), compared at ``rtol = 1e-4`` and ``atol = 1e-4 * max(1, max |logit|)``: the two
  libraries sum convolutions and matmuls in other orders;
- the train-mode forward (batch-statistics BN, dropout 0 on both sides) in fp64 on another
  (``jax.enable_x64``, ``FP64_COMPILE``), logits and updated BN means at ``rtol = 1e-9``.
"""

import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from torch_jax_init import FP64_COMPILE
from torch_seg_parity import check_torch_keys_reach_jax, load_port, numpy_tree, seeded_variables

EVAL_RTOL = 1e-4
RTOL64 = 1e-9


def run_family(case, jmod, net, rules, jax_rules, hw, batch=2):
    """One family's parity case; returns what its three tests check."""
    variables = seeded_variables(jmod, hw, seed=len(case))
    load_port(net, variables, rules)
    x32 = np.random.RandomState(1).randn(batch, *hw, 3).astype(np.float32)
    ref32 = np.asarray(jax.jit(functools.partial(jmod.apply, train=False))(variables, jnp.asarray(x32)))
    with torch.no_grad():
        got32 = copy.deepcopy(net).eval()(torch.from_numpy(x32).permute(0, 3, 1, 2)).numpy()

    x64 = np.random.RandomState(2).randn(batch, *hw, 3)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        apply = functools.partial(jmod.apply, train=True, mutable=["batch_stats"])
        out, mutated = jax.jit(apply, compiler_options=FP64_COMPILE)(v64, jnp.asarray(x64))
        ref64 = np.asarray(out)
        stats = numpy_tree(mutated.get("batch_stats", {}))
    net64 = copy.deepcopy(net).double().train()
    with torch.no_grad():
        got64 = net64(torch.from_numpy(x64).permute(0, 3, 1, 2)).numpy()
    return types.SimpleNamespace(case=case, variables=variables, net=net, rules=rules, jax_rules=jax_rules,
                                 eval=(got32, ref32), train=(got64, ref64, stats, net64))


def check_weights_carry(r):
    """The JAX tree loads into the port strictly (``load_port`` above) and converts back bit for
    bit; the port's ``state_dict`` reaches the JAX tree through the JAX package's own mapper."""
    back = variables_from_jax_to_torch(r.variables, r.rules)
    sd = r.net.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    check_torch_keys_reach_jax(r.net, r.variables, r.jax_rules)


def check_eval(r):
    got, ref = r.eval
    assert got.shape == ref.shape and np.isfinite(ref).all() and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=EVAL_RTOL, atol=EVAL_RTOL * max(1.0, float(np.abs(ref).max())))


def check_train64(r):
    got, ref, stats, net64 = r.train
    np.testing.assert_allclose(got, ref, rtol=RTOL64, atol=RTOL64)
    if not stats:
        return
    jax_sd = variables_from_jax_to_torch({"params": r.variables["params"], "batch_stats": stats}, r.rules)
    means = [k for k in jax_sd if k.endswith("running_mean")]
    assert len(means) == sum(isinstance(m, torch.nn.BatchNorm2d) for m in net64.modules())
    port = net64.state_dict()
    for key in means:
        torch.testing.assert_close(port[key], jax_sd[key].double(), rtol=RTOL64, atol=1e-12, msg=key)
