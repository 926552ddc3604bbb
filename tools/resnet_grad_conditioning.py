"""How sensitive one ResNet-50 training step's gradient is to rounding,
on the CPU.

Builds ResNet-50 (``ImageClassifier``, 10 classes) with the port's
initial weights, draws the gamma of the last BatchNorm of every
bottleneck branch from U(lo, hi) (lo = hi = 0: zero-init residual
branches), and takes one step's gradient on ``--rows`` seeded images:

- the port in float32 and JAX in float32 (one device), each against the
  port in float64: the worst tensor's ``||g - g64|| / ||g64||``;
- the port in float32 from the images changed by a relative 1e-6: how
  far a rounding-sized change of the input moves the gradient (ReLU
  masks near zero flip), the worst tensor and the median;
- the smallest float64 gradient norm of a convolution kernel.

Run from the repo root, for example::

    PYTHONPATH=. python tools/resnet_grad_conditioning.py --size 64 \\
        --gamma 0.1 0.25 --seeds 0 1 2

``--no-jax`` skips the JAX run. Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _gradients(model, x, y, dtype):
    from analytics_zoo_tpu_torch.pipeline.api.keras.objectives import \
        get_loss
    model.to(dtype)
    out = model(torch.from_numpy(x).to(dtype), training=True)
    loss = get_loss("sparse_categorical_crossentropy")(
        out, torch.from_numpy(y), torch.ones(len(y), dtype=dtype))
    loss.backward()
    return [(n, p.grad.double()) for n, p in model.named_parameters()]


def _worst(grads, ref):
    rel = sorted((((g - r).norm() / r.norm()).item()
                  if r.norm() > 0 else 0.0, n)
                 for (n, g), (_, r) in zip(grads, ref))
    return rel[-1], rel[len(rel) // 2][0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--gamma", type=float, nargs=2, default=(0.1, 0.25))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--no-jax", action="store_true")
    args = ap.parse_args(argv)
    from analytics_zoo_tpu_torch.common import nncontext as tnn
    from analytics_zoo_tpu_torch.models.image import \
        imageclassification as tic
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as tl
    from analytics_zoo_tpu_torch.utils import load_jax_params
    tnn.init_nncontext(device="cpu")
    shape, classes = (3, args.size, args.size), 10
    lo, hi = args.gamma

    def build():
        return tic.ImageClassifier(class_num=classes, model_name="resnet-50",
                                   input_shape=shape).model

    for seed in args.seeds:
        torch.manual_seed(seed)
        base = build()
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for node in base.graph_function().nodes:
                if isinstance(node.layer, tl.Add):
                    g = node.inputs[0].node.layer.gamma
                    g.copy_(lo + (hi - lo) * torch.rand(g.shape,
                                                        generator=gen))
        rs = np.random.default_rng(seed + 2)
        x = rs.standard_normal((args.rows,) + shape).astype(np.float32)
        y = rs.integers(0, classes, args.rows).astype(np.int32)
        nudged = (x * (1 + 1e-6 * rs.standard_normal(x.shape))).astype(
            np.float32)
        params = {layer.name: {k: v.detach().numpy().copy()
                               for k, v in layer.param_tree().items()}
                  for layer in base.graph_function().layers
                  if layer.param_tree()}

        def twin():
            m = build()
            with torch.no_grad():
                for a, b in zip(list(m.parameters()) + list(m.buffers()),
                                list(base.parameters()) +
                                list(base.buffers())):
                    a.copy_(b)
            return m

        g64 = _gradients(twin(), x, y, torch.float64)
        g32 = _gradients(twin(), x, y, torch.float32)
        moved = _gradients(twin(), nudged, y, torch.float32)
        out = dict(seed=seed, size=args.size, rows=args.rows, gamma=[lo, hi],
                   port_f32_vs_f64=_worst(g32, g64)[0],
                   nudged_input_worst=_worst(moved, g32)[0],
                   nudged_input_median=_worst(moved, g32)[1],
                   min_conv_kernel_grad_norm=min(
                       g.norm().item() for n, g in g64
                       if n.endswith(".kernel") and "convolution" in n))
        if not args.no_jax:
            out["jax_f32_vs_f64"] = _worst(
                _jax_gradients(base, params, build, x, y, shape, classes,
                               load_jax_params), g64)[0]
        print(json.dumps(out), flush=True)


def _jax_gradients(base, params, build, x, y, shape, classes,
                   load_jax_params):
    """JAX's float32 gradient of the same step, as port-ordered tensors."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from analytics_zoo_tpu.common import nncontext as jnn
    from analytics_zoo_tpu.models.image import imageclassification as jic
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(),
                                     devices=jax.devices()[:1]))
    graph = jic.ImageClassifier(class_num=classes, model_name="resnet-50",
                                input_shape=shape).model.graph_function()
    jlayers = graph.layers
    tlayers = base.graph_function().layers
    jparams = {j.name: params[t.name] for j, t in zip(jlayers, tlayers)
               if t.name in params}
    state = {j.name: {k: v.numpy() for k, v in t.state_tree().items()}
             for j, t in zip(jlayers, tlayers) if t.state_tree()}

    def loss(p):
        o, _ = graph.apply(p, [x], state=state, training=True,
                           collect_state=True)
        return -jnp.mean(jnp.log(o[jnp.arange(len(y)), y]))

    grads = jax.jit(jax.grad(loss))(jparams)
    twin = build()
    load_jax_params(twin, jax.tree.map(np.asarray, grads))
    return [(n, p.detach().double()) for n, p in twin.named_parameters()]


if __name__ == "__main__":
    main()
