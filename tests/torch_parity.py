"""Pair a JAX model's parameter leaves with the port's, layer by layer.

Both packages list ``get_weights()`` sorted by layer name, and each
numbers its auto-named layers from its own counters, whose values depend
on which tests ran first in the process. Once the two models' names
cross a digit boundary apart ("dense_9" < "dense_10" as numbers, not as
strings), the two sorted orders differ, and zipping the two lists
compares a layer with another one. The pairs here follow the rule
``load_jax_params`` copies the weights by (``utils/jax_weights.py``): a
user-given name pairs by name, an auto-named layer by class and creation
order. Imports no JAX: the JAX tree comes in as it is.
"""

import numpy as np

from analytics_zoo_tpu_torch.utils.jax_weights import _pair_layers, _restack


def paired_leaves(tmodel, jparams):
    """``[(path, port leaf, JAX leaf)]`` as numpy, for every parameter of
    the port model ``tmodel`` (a graph model, or one layer) and the JAX
    params tree ``jparams`` (``{layer name: {...}}``; ``get_params()`` or
    a trainer's ``params``). ``path`` is the port's parameter path.
    Raises where the two trees' leaves do not line up."""
    layers = (tmodel.graph_function().layers
              if hasattr(tmodel, "graph_function") else [tmodel])
    with_params = [l for l in layers if any(True for _ in l.parameters())]
    out = []
    for layer, name in _pair_layers(with_params, jparams):
        port = {k: v.detach().cpu().numpy()
                for k, v in layer.named_parameters()}
        theirs = _restack(jparams[name], port)
        if set(port) != set(theirs):
            raise AssertionError(
                f"{layer.name} <- {name}: port leaves {sorted(port)}, JAX "
                f"leaves {sorted(theirs)}")
        for k in sorted(port):
            out.append((f"{layer.name}.{k}", port[k], np.asarray(theirs[k])))
    return out


def assert_weights_match(tmodel, jparams, atol, rtol=0.0):
    """Each port parameter within ``atol`` (and ``rtol``) of the JAX leaf
    it pairs with; shapes equal."""
    pairs = paired_leaves(tmodel, jparams)
    assert pairs, "no parameters to compare"
    for path, got, want in pairs:
        assert got.shape == want.shape, (path, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=path)

