from .jax_weights import load_jax_params

__all__ = ["load_jax_params"]
