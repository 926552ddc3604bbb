"""The port's utilities. ``load_jax_params`` and ``load_jax_decode_state``
(``jax_weights``) load on first use: that module imports torch, which a
spawned infeed worker (``feature/infeed_worker.py``, importing this
package for ``faults`` and ``telemetry``) should not pay for at start."""

__all__ = ["load_jax_decode_state", "load_jax_params"]


def __getattr__(name):
    if name in __all__:
        from . import jax_weights
        return getattr(jax_weights, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
