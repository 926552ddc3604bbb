"""Hold a model's forward and backward, layer by layer, against another
device's.

A whole-model gradient compared between two devices mixes each layer's
arithmetic with how sensitive the model is to rounding. ResNet-50 from
random weights is very sensitive: one float32 step on 2 images of
224x224 lands 0.4-0.7% (of the worst tensor's norm) from the float64
step, and a relative 1e-6 change of the input moves its gradient by
0.7-1.2%, since ReLU masks near zero flip
(``tools/resnet_grad_conditioning.py``). So a card and a CPU that each
compute every layer right still part there by more than any float32
limit.

``LayerRecorder`` records, while a model runs forward and backward (for
example inside ``SPMDTrainer.train_step``), each layer call's inputs and
output and the gradients that reach them. ``compare_layers`` then runs
each layer again on a reference copy of the model (on the CPU) from the
recorded inputs, in the recorded dtype, back-propagates the recorded
output gradient, and measures how far the recorded output, input
gradients and parameter gradients are from the reference's, each over
the reference's norm. Every layer then meets the inputs it met on the
device, so the comparison shows each layer's own arithmetic.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def _tensors(x) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _rel(got, want) -> float:
    """||got - want|| / ||want|| in float64 on the CPU (0 when both are
    0)."""
    got, want = (t.detach().cpu().double() for t in (got, want))
    den = want.norm().item()
    num = (got - want).norm().item()
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


class LayerRecorder:
    """Context manager over ``model``'s graph layers: each call records
    ``x`` (the inputs, as given), ``y`` (the output), ``kwargs`` and,
    after the backward, ``dx`` (each input's gradient from this layer
    alone, None where the input needs none) and ``dy``. One call per
    layer (a layer called twice keeps its last call). Stochastic layers
    (dropout) are not recorded: their draws come from the device's
    generator."""

    def __init__(self, model):
        self.layers = model.graph_function().layers
        self.records: Dict[str, dict] = {}
        self._handles = []

    def __enter__(self):
        for layer in self.layers:
            if layer.stochastic:
                continue
            self._handles.append(layer.register_forward_pre_hook(
                self._before, with_kwargs=True))
            self._handles.append(layer.register_forward_hook(
                self._after, with_kwargs=True))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []

    def _before(self, layer, args, kwargs):
        rec = self.records[layer.name] = dict(
            kwargs=dict(kwargs), listed=isinstance(args[0], (list, tuple)))
        xs = _tensors(args[0])
        # a view per input: its gradient is this layer's share alone
        views = [x.view_as(x) for x in xs]
        rec["x"], rec["dx"] = views, [None] * len(views)
        for i, v in enumerate(views):
            if v.requires_grad:
                v.register_hook(lambda g, i=i: rec["dx"].__setitem__(i, g))
        x = views if rec["listed"] else views[0]
        return (x,) + tuple(args[1:]), kwargs

    def _after(self, layer, args, kwargs, out):
        if not isinstance(out, torch.Tensor):   # a multi-output layer
            del self.records[layer.name]
            return
        rec = self.records[layer.name]
        rec["y"], rec["dy"] = out, None
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("dy", g))


def compare_layers(recorder: LayerRecorder, reference_model,
                   device="cpu", also_in=None) -> Dict[str, dict]:
    """Each recorded layer run again on ``reference_model``'s layer of the
    same position (the same code built both models, from the same
    weights) on ``device``: its inputs and parameters in the recorded
    input's dtype, the recorded output gradient back-propagated.

    Returns ``{layer name: {"y": rel, "dx": [rel, ...], param name: rel,
    ...}}`` over the reference's norms, where each parameter's recorded
    gradient is the ``.grad`` of the recorded model's parameter (its
    float32 master's, under a compute dtype) and ``"ref_norm"`` holds
    the reference parameter gradients' norms. With ``also_in`` (a dtype)
    each layer also runs in that dtype from the same inputs upcast, and
    ``"vs_<dtype>"`` holds the reference's own distance from that run:
    what the narrower arithmetic alone moves."""
    ref_layers = reference_model.graph_function().layers
    out = {}
    for layer, ref in zip(recorder.layers, ref_layers):
        if type(layer) is not type(ref):
            raise ValueError(f"{layer.name} and {ref.name} differ in class")
        rec = recorder.records.get(layer.name)
        if rec is None:
            continue
        dtype = next((x.dtype for x in rec["x"] if x.is_floating_point()),
                     torch.float32)
        want = _rerun(ref, rec, device, dtype)
        res = {"y": _rel(rec["y"], want["y"]),
               "dx": [None if g is None else _rel(g, w)
                      for g, w in zip(rec["dx"], want["dx"])],
               "ref_norm": {}}
        for name, p in layer.named_parameters():
            ref_grad = want["grads"][name]
            res[name] = _rel(torch.zeros_like(p) if p.grad is None
                             else p.grad, ref_grad)
            res["ref_norm"][name] = ref_grad.double().norm().item()
        if also_in is not None:
            wide = _rerun(ref, rec, device, also_in)
            res["vs_" + str(also_in).replace("torch.", "")] = max(
                [_rel(want["y"], wide["y"])] +
                [_rel(want["grads"][k], wide["grads"][k])
                 for k in want["grads"]])
        out[layer.name] = res
    return out


def _rerun(layer, rec, device, dtype):
    xs = [x.detach().to(device=device,
                        dtype=dtype if x.is_floating_point() else x.dtype)
          .requires_grad_(x.requires_grad) for x in rec["x"]]
    params = {k: p.detach().to(device=device, dtype=dtype)
              .requires_grad_(True) for k, p in layer.named_parameters()}
    y = torch.func.functional_call(
        layer, params, (xs if rec["listed"] else xs[0],), rec["kwargs"])
    leaves = [t for t in list(params.values()) + xs if t.requires_grad]
    grads = [None] * len(leaves)
    if rec["dy"] is not None and leaves:
        grads = torch.autograd.grad(
            y, leaves, rec["dy"].to(device=device, dtype=y.dtype),
            allow_unused=True)
    by_leaf = {id(t): torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, grads)}
    return dict(y=y.detach(),
                grads={k: by_leaf[id(p)] for k, p in params.items()},
                dx=[by_leaf.get(id(x)) for x in xs])
