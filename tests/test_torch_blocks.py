"""Conv blocks and the SPP pool pyramid of the PyTorch port against the JAX package.

Weights are made by the flax modules' init (BatchNorm statistics and affine
randomized so that folding them is not the identity), carried to the port by
``variables_from_jax_to_torch``, and both forwards run in fp32 on the same
numpy input. Tolerance port vs JAX: ``atol=5e-4`` (``tests/parity_utils.py``:
oneDNN and XLA sum convolutions in different orders); port fused vs port
unfused: ``atol=1e-4``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_utils import assert_close
from super_gradients_tpu.modules import blocks as jblocks
from super_gradients_tpu.ops.pooling import chained_max_pools as jax_chained_max_pools
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.modules import blocks
from super_gradients_tpu_torch.ops.pooling import chained_max_pools

torch.set_num_threads(2)

EPS = 1e-3  # YOLO-NAS BatchNorm eps


def _randomize(variables, seed):
    """numpy copy of flax variables with random BN statistics, BN affine and alpha."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.array(x, dtype=np.float32)
        name = path[-1].key
        if name == "mean":
            return rng.randn(*x.shape).astype(np.float32) * 0.1
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("scale", "alpha"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return rng.randn(*x.shape).astype(np.float32) * 0.1
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _jax_apply(module, variables, x_nhwc, **kw):
    return np.asarray(module.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x_nhwc), **kw))


def _port_apply(module, x_nhwc):
    with torch.no_grad():
        y = module.eval()(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous())
    return y.permute(0, 2, 3, 1).numpy()


def _input(seed, c, hw=(12, 10)):
    return np.random.RandomState(seed).randn(2, hw[0], hw[1], c).astype(np.float32)


@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2)])
def test_conv_bn_act(kernel, stride):
    x = _input(0, 6)
    jm = jblocks.ConvBNAct(out_channels=8, kernel=kernel, stride=stride, bn_eps=EPS)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    pm = blocks.ConvBNAct(6, 8, kernel, stride, bn_eps=EPS)
    pm.load_state_dict(variables_from_jax_to_torch(variables), strict=True)
    assert_close(_port_apply(pm, x), _jax_apply(jm, variables, x, train=False), atol=5e-4, name="ConvBNAct")


QAREP_CASES = {
    "residual": dict(cin=8, out=8, stride=1, use_residual=True, use_alpha=False),
    "residual_alpha": dict(cin=8, out=8, stride=1, use_residual=True, use_alpha=True),
    "plain_stride1": dict(cin=4, out=8, stride=1, use_residual=False, use_alpha=False),
    "plain_stride2": dict(cin=3, out=8, stride=2, use_residual=False, use_alpha=False),
    "plain_stride2_alpha": dict(cin=4, out=8, stride=2, use_residual=False, use_alpha=True),
}


def _qarep_pair(case):
    c = QAREP_CASES[case]
    x = _input(2, c["cin"])
    kw = dict(stride=c["stride"], use_residual=c["use_residual"], use_alpha=c["use_alpha"], bn_eps=EPS)
    jm = jblocks.QARepVGGBlock(out_channels=c["out"], **kw)
    variables = _randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 3)
    pm = blocks.QARepVGGBlock(c["cin"], c["out"], **kw)
    pm.load_state_dict(variables_from_jax_to_torch(variables), strict=True)
    return x, jm, variables, pm, kw, c


@pytest.mark.parametrize("case", list(QAREP_CASES))
def test_qarepvgg_unfused_matches_jax(case):
    x, jm, variables, pm, _, _ = _qarep_pair(case)
    assert_close(_port_apply(pm, x), _jax_apply(jm, variables, x, train=False), atol=5e-4, name="QARepVGG unfused")


@pytest.mark.parametrize("case", list(QAREP_CASES))
def test_qarepvgg_fused_matches_jax_and_unfused(case):
    x, jm, variables, pm, kw, c = _qarep_pair(case)
    unfused = _port_apply(pm, x)
    # the JAX package's fusion math on the same weights
    _, _, full = jblocks.fuse_qarepvgg_params(variables["params"], variables["batch_stats"], jm)
    jfused = jblocks.QARepVGGBlock(out_channels=c["out"], fused="full", **kw)
    ref = _jax_apply(jfused, {"params": full}, x, train=False)

    pm.fuse_()
    assert pm.fused and set(pm.state_dict()) == {"rbr_reparam.weight", "rbr_reparam.bias"}
    fused_sd = variables_from_jax_to_torch({"params": jax.device_get(full)})
    np.testing.assert_allclose(pm.rbr_reparam.weight.detach().numpy(), fused_sd["rbr_reparam.weight"].numpy(), atol=1e-5)
    np.testing.assert_allclose(pm.rbr_reparam.bias.detach().numpy(), fused_sd["rbr_reparam.bias"].numpy(), atol=1e-5)
    got = _port_apply(pm, x)
    assert_close(got, ref, atol=5e-4, name="QARepVGG fused vs JAX fused")
    np.testing.assert_allclose(got, unfused, atol=1e-4, rtol=0)

    # the deploy form loads a fused JAX tree directly
    built_fused = blocks.QARepVGGBlock(c["cin"], c["out"], fused=True, **kw)
    built_fused.load_state_dict(fused_sd, strict=True)
    assert_close(_port_apply(built_fused, x), ref, atol=5e-4, name="QARepVGG built fused")


def test_qarepvgg_rejects_impossible_residual():
    with pytest.raises(ValueError):
        blocks.QARepVGGBlock(4, 8, use_residual=True)


def test_conv_transpose_2x2_matches_jax():
    x = _input(4, 6, hw=(5, 7))
    jm = jblocks.ConvTranspose2x2(out_channels=4)
    params = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))["params"]
    params = {"kernel": np.asarray(params["kernel"]), "bias": np.random.RandomState(5).randn(4).astype(np.float32)}
    holder = torch.nn.Module()
    holder.upsample = torch.nn.ConvTranspose2d(6, 4, kernel_size=2, stride=2)
    holder.load_state_dict(variables_from_jax_to_torch({"params": {"upsample": params}}), strict=True)
    got = _port_apply(holder.upsample, x)
    assert got.shape == (2, 10, 14, 4)
    assert_close(got, _jax_apply(jm, {"params": params}, x), atol=5e-4, name="ConvTranspose2x2")


def test_chained_max_pools_match_jax():
    # coarse integer grid: many ties inside every window
    x = np.random.RandomState(6).randint(-3, 4, size=(2, 11, 9, 5)).astype(np.float32)
    ref = jax_chained_max_pools(jnp.asarray(x), (5, 9, 13))
    got = chained_max_pools(torch.from_numpy(x).permute(0, 3, 1, 2), (5, 9, 13))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.permute(0, 2, 3, 1).numpy(), np.asarray(r))


@pytest.mark.parametrize("momentum", [0.03, 0.1])
def test_conv_bn_act_train_mode_matches_jax(momentum):
    """Train mode: the outputs (batch statistics) and the new running mean match
    JAX; the BN momentum is passed through in torch's convention (JAX stores
    1 - momentum). The running variance is torch's unbiased update: the JAX one's
    batch variance times n/(n-1), n = B*H*W (a divergence kept on purpose)."""
    x = _input(7, 6, hw=(3, 5))  # n = 2 * 3 * 5 = 30
    jm = jblocks.ConvBNAct(out_channels=8, kernel=3, bn_eps=EPS, bn_momentum=momentum)
    variables = _randomize(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), 8)
    y_ref, mutated = jm.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    pm = blocks.ConvBNAct(6, 8, 3, bn_eps=EPS, bn_momentum=momentum)
    pm.load_state_dict(variables_from_jax_to_torch(variables), strict=True)
    v0 = pm.bn.running_var.clone()
    with torch.no_grad():
        y = pm.train()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert_close(y.permute(0, 2, 3, 1).numpy(), np.asarray(y_ref), atol=5e-4, name="ConvBNAct train")
    stats = jax.device_get(mutated["batch_stats"]["bn"])
    np.testing.assert_allclose(pm.bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6, rtol=1e-5)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    batch_var_biased = (np.asarray(stats["var"]) - (1 - momentum) * v0.numpy()) / momentum
    expected = (1 - momentum) * v0.numpy() + momentum * batch_var_biased * n / (n - 1)
    np.testing.assert_allclose(pm.bn.running_var.numpy(), expected, atol=1e-6, rtol=1e-5)
    assert not np.allclose(pm.bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6, rtol=1e-5)


def test_chained_max_pools_backward_matches_jax_on_ties():
    """Each output's gradient goes to the first max of its window in row-major order
    (the JAX custom VJP); torch's max_pool2d backward does the same, through the
    three chained pools. Integer inputs tie inside every window; integer
    cotangents make the sums exact."""
    rng = np.random.RandomState(8)
    x = rng.randint(-2, 3, size=(2, 11, 9, 5)).astype(np.float32)
    cot = [rng.randint(-3, 4, size=x.shape).astype(np.float32) for _ in range(3)]

    def f(v):
        return sum(jnp.sum(o * c) for o, c in zip(jax_chained_max_pools(v, (5, 9, 13)), cot))

    ref = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    outs = chained_max_pools(xt, (5, 9, 13))
    sum((o * torch.from_numpy(c).permute(0, 3, 1, 2)).sum() for o, c in zip(outs, cot)).backward()
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(), ref)


def test_chained_max_pools_reject_even_kernels():
    with pytest.raises(ValueError):
        chained_max_pools(torch.zeros(1, 1, 8, 8), (5, 8))
