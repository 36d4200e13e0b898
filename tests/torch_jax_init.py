"""JAX reference variables without a compiled init, for the port's parity tests.

A flax ``init`` is a program of its own: compiling it costs as much as the forward it serves
(8-30 s a model on the CPU), so a cold run pays for it again each time. :func:`flax_like_variables`
traces the init (``jax.eval_shape``, nothing compiled) and fills the tree as flax's default
initializers do, the kernels drawn from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np

# the compile options of the fp64 references: XLA's backend level 1, where this suite's level 0
# (tests/conftest.py) runs fp64 convolutions and matmuls four to five times slower
FP64_COMPILE = {"xla_backend_optimization_level": "1"}


def flax_like_variables(module, x_shape, seed, **init_kwargs):
    """Variables of ``module`` for an input of ``x_shape``: LeCun-normal kernels (variance
    ``1 / fan_in``) from ``np.random.RandomState(seed)``, zero biases and BN means, unit BN and
    LayerNorm scales, BN variances and ``alpha`` factors."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x_shape), **init_kwargs))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (np.ones if leaf in ("scale", "var", "alpha") else np.zeros)(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def param_count(module, x_shape, **init_kwargs):
    """The parameter count of ``module`` from its traced init."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x_shape), **init_kwargs))
    return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))


def jax_model(name, variables=None, seed=0, **kwargs):
    """The JAX zoo's task model of ``name`` as ``models.get(name, **kwargs)`` wraps it, holding
    ``variables`` (else :func:`flax_like_variables` from ``seed`` at its init size) in place of
    a compiled init."""
    from super_gradients_tpu.models.model_factory import TASK_WRAPPERS, get_architecture

    spec = get_architecture(name)(num_classes=kwargs.pop("num_classes", None), arch_params=kwargs.pop("arch_params", None)
                                  or {}, **kwargs)
    hw = spec.init_hw or spec.input_hw
    if variables is None:
        variables = flax_like_variables(spec.module, (1, *hw, 3), seed, train=False)
    wrapper = spec.wrapper_cls or TASK_WRAPPERS[spec.task]
    return wrapper(name=name, module=spec.module, variables=jax.tree_util.tree_map(jnp.asarray, variables),
                   num_classes=spec.num_classes, config=spec.config, processing=spec.processing,
                   class_names=spec.class_names, input_hw=spec.input_hw)
