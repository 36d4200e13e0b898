"""Shared parity helpers of the segmentation-zoo tests (``test_torch_ddrnet_regseg.py``,
``test_torch_segformer_unet.py``): JAX variables drawn from a numpy seed (no JAX init is
compiled: ``jax.eval_shape`` gives the tree), the JAX module applied under ``jax.jit`` in fp64,
one fp64 SGD step on each side, and the checks that hold the port to them.

Every comparison runs in fp64 on both sides (``jax.enable_x64``, ``net.double()``), where the
two libraries agree to ``rtol = atol = 1e-9`` (``RTOL``) on these unit-scale networks. BN
running variances are flax's biased update and torch's unbiased one, mapped by
``c = n / (n - 1)`` with ``n`` the values a channel saw.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from super_gradients_tpu.conversion import torch_converter as tc
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from torch_jax_init import FP64_COMPILE

RTOL = 1e-9
LR = 0.1


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def tree_size(tree):
    return sum(int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(tree))


def seeded_variables(module, hw, seed, channels=3):
    """Variables of ``module`` at ``hw`` (``channels`` input channels) drawn from
    ``np.random.RandomState(seed)``: He-normal kernels, small biases, scales near 1, BN means near
    0 and variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, channels)), train=False))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if leaf == "var":
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)  # biases and BN means

    return jax.tree_util.tree_map_with_path(draw, shapes)


def load_port(net, variables, rules):
    """``net`` with the JAX ``variables`` loaded strictly through ``conversion/from_jax.py``."""
    net.load_state_dict(variables_from_jax_to_torch(variables, rules), strict=True)
    return net


def check_torch_keys_reach_jax(net, variables, jax_rules):
    """The port's ``state_dict`` converts into the JAX tree strictly through the JAX package's
    own mapper (the original checkpoint's names), every tensor landing where it came from."""
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    back = numpy_tree(tc.convert_state_dict(sd, template, jax_rules, strict=True))
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        got = back
        for p in path:
            got = got[p.key]
        assert got.shape == leaf.shape, path


def _as64(variables):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)


def _run64(fn, *args):
    """``fn(*args)`` compiled with the fp64 references' options (``FP64_COMPILE``)."""
    return jax.jit(fn, compiler_options=FP64_COMPILE)(*args)


def _ce(logits_nhwc, labels):
    logp = jax.nn.log_softmax(logits_nhwc, axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


def _outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def jax_reference64(module, variables, x_eval=None, step=None):
    """The JAX module in fp64, one compiled program for both parts: the eval-mode outputs on
    ``x_eval`` and, for ``step = (x, labels)``, one train-mode step of the summed cross-entropy
    of every output (the outputs, the updated batch statistics and the parameters after SGD at
    ``LR``). Returns ``(eval outputs or None, step results or None)``."""
    with jax.enable_x64():
        v64 = _as64(variables)

        def loss_fn(params, x, labels):
            out, mutated = module.apply({"params": params, "batch_stats": v64["batch_stats"]}, x, train=True,
                                        mutable=["batch_stats"])
            outs = out if isinstance(out, tuple) else (out,)
            return sum(_ce(o, labels) for o in outs), (outs, mutated["batch_stats"])

        def program(v, x_eval, x, labels):
            eval_out = None if x_eval is None else module.apply(v, x_eval, train=False)
            trained = None if x is None else jax.grad(loss_fn, has_aux=True)(v["params"], x, labels)
            return eval_out, trained

        x, labels = (None, None) if step is None else (jnp.asarray(step[0], jnp.float64), jnp.asarray(step[1]))
        eval_out, trained = _run64(program, v64, None if x_eval is None else jnp.asarray(x_eval, jnp.float64), x,
                                   labels)
        if trained is None:
            return _outputs(eval_out), None
        grads, (outs, stats) = trained
        params = jax.tree_util.tree_map(lambda p, g: p - LR * g, v64["params"], grads)
        return (None if eval_out is None else _outputs(eval_out)), ([np.asarray(o) for o in outs], numpy_tree(stats),
                                                                     numpy_tree(params))


def bn_sizes_hooks(net, sizes):
    """Hooks that record each BN's ``(values a channel, momentum)`` under its name."""
    return [m.register_forward_pre_hook(
        lambda mod, inp, n=n: sizes.__setitem__(n, (inp[0].numel() // inp[0].shape[1], mod.momentum)))
        for n, m in net.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]


def port_step64(net, x, labels):
    """The port's counterpart of :func:`jax_step64` on ``net`` in fp64: the outputs (NHWC),
    each BN's values a channel and momentum, the state before and the state after."""
    net = net.double().train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    sizes = {}
    hooks = bn_sizes_hooks(net, sizes)
    out = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    outs = out if isinstance(out, tuple) else (out,)
    target = torch.from_numpy(labels).long()
    loss = sum(torch.nn.functional.cross_entropy(o, target) for o in outs)
    loss.backward()
    with torch.no_grad():
        for p in net.parameters():
            p -= LR * p.grad
    return [o.detach().permute(0, 2, 3, 1).numpy() for o in outs], sizes, before, net.state_dict()


def check_step(jax_result, port_result, rules):
    """Outputs, parameters and BN buffers of the two fp64 steps agree."""
    j_outs, j_stats, j_params = jax_result
    p_outs, sizes, before, after = port_result
    assert len(j_outs) == len(p_outs)
    for g, r in zip(p_outs, j_outs):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=RTOL)
    ref = variables_from_jax_to_torch({"params": j_params, "batch_stats": j_stats}, rules)
    checked = 0
    for key, value in after.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith("running_var"):
            prefix = key[: -len(".running_var")]
            n, m = sizes[prefix]
            c = n / (n - 1)
            old = before[key]
            # flax: (1 - m) old + m biased; torch: (1 - m) old + m c biased
            expected = (1 - m) * old + c * (ref[key].double() - (1 - m) * old)
            torch.testing.assert_close(value, expected, rtol=RTOL, atol=1e-12, msg=key)
        else:
            torch.testing.assert_close(value, ref[key].double(), rtol=RTOL, atol=RTOL, msg=key)
        checked += 1
    assert checked == len(ref) - sum(k.endswith("num_batches_tracked") for k in ref)
    return sizes


def port_eval64(net, x):
    """The port net's eval-mode outputs (NHWC, or as they are where not a map) in fp64, on a copy."""
    with torch.no_grad():
        out = copy.deepcopy(net).double().eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return [o.permute(0, 2, 3, 1).numpy() if o.dim() == 4 else o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def run_case(case, build, rules, hw, evaluate, train, num_classes=5):
    """One parity case: ``build()`` gives (JAX module, port net); the JAX variables are drawn
    from the case's seed and loaded into the net; where asked, both packages' fp64 eval outputs
    on one seeded batch and their fp64 steps on another (the JAX parts one compiled program)."""
    jmod, net = build()
    variables = seeded_variables(jmod, hw, seed=len(case))
    load_port(net, variables, rules)
    rng = np.random.RandomState(11)
    x_eval = np.random.RandomState(hw[1]).randn(2, *hw, 3) if evaluate else None
    step = (rng.randn(2, *hw, 3), rng.randint(0, num_classes, (2, *hw)).astype(np.int32)) if train else None
    j_eval, j_step = jax_reference64(jmod, variables, x_eval, step)
    return types.SimpleNamespace(
        case=case, jmod=jmod, variables=variables, net=net,
        eval=(j_eval, port_eval64(net, x_eval)) if evaluate else None,
        step=(j_step, port_step64(copy.deepcopy(net), *step)) if train else None)
