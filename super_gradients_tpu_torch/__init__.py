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
    "models": "super_gradients_tpu_torch.models",
    "training": "super_gradients_tpu_torch.training",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name])
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["models", "training", "__version__"]
