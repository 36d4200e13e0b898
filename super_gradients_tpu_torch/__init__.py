"""super_gradients_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of
``super_gradients_tpu``.

The JAX package stays the reference; every module here mirrors the JAX module of
the same relative path and is held to it by ``tests/test_torch_*.py``. This
package imports ``torch`` and never ``jax``, ``flax`` or ``super_gradients_tpu``.

Subpackages load lazily (PEP 562), as in the JAX package, so that importing the
ops alone does not build the model zoo.
"""

__version__ = "0.1.0"

_LAZY = {
    "models": ("super_gradients_tpu_torch.models", None),
    "training": ("super_gradients_tpu_torch.training", None),
    "setup_device": ("super_gradients_tpu_torch.parallel.mesh", "setup_device"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module_name, attr = _LAZY[name]
        mod = importlib.import_module(module_name)
        obj = mod if attr is None else getattr(mod, attr)
        globals()[name] = obj
        return obj
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["models", "training", "setup_device", "__version__"]
