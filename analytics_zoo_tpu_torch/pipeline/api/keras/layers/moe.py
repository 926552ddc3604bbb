"""Sparse Mixture-of-Experts layer.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/moe.py``: the
top-k gated mixture of expert MLPs, expert weights stacked ``(E, ...)``
(``router_w`` (H, E), ``w_in`` (E, H, F), ``b_in`` (E, F), ``w_out``
(E, F, H), ``b_out`` (E, H)).

The JAX layer dispatches through dense one-hot ``dispatch`` and
``combine`` tensors of shape (N, E, C), which suits XLA's static shapes.
At BERT-base's 32 x 512 tokens with 8 experts, top-2 and capacity factor
1.25, C is 5,120 and each of those tensors holds 671M values. Here the
same slot assignment is computed as index tensors instead: each expert's
(E, C, H) input is a gather of the token rows its slots hold (empty slots
read a zero row), the experts' products are batched matmuls over the
stacked weights, and each token's up to k weighted expert outputs are
scatter-added back (``index_add``). No (N, E, C) tensor is made, and
no shape depends on the routing, so a step makes no host sync. The four
parts run under ``torch.profiler.record_function`` scopes
(``moe/router``, ``moe/dispatch``, ``moe/experts``, ``moe/combine``),
which a profile of a step reads to split the device time.

What matches JAX exactly (:func:`assign_slots`):

- slots fill slot 0 first, for all tokens in token order, then slot 1;
  each expert's position counts on from ``used``, which counts every
  assignment of the earlier slots, including those dropped past
  capacity;
- an assignment past capacity is dropped: zero dispatch and zero combine
  weight, never re-routed;
- the router's logits are computed in the input's dtype, the softmax in
  float32; the top-k weights are renormalised with the 1e-9 floor, and
  tied gates pick the lower expert index first, as ``jax.lax.top_k``
  does (a stable descending sort).

Expert parallelism (``expert_parallel`` = ep > 1; JAX lays the stacked
weights over the expert axis and lets GSPMD move the tokens): under the
trainer's layout each expert rank holds E/ep of the stacked ``(E, ...)``
weights, and the layer reads it from their shapes. The rows are not
split over the expert axis, so every expert rank routes every token
(capacity and slots as above, over all E experts), fills and runs only
its own experts' slots, and the combined output is all-reduced over the
expert group (``reduce_from_region``); the token rows and the top-k
weights enter through ``copy_to_region``, so the router and the layer
below get the whole gradient on every rank. With ``model`` > 1 the
experts' ``mlp`` dimension is cut too (``w_in``/``b_in`` columns,
``w_out`` rows): each model rank computes its part of every slot's
hidden layer and the second product is summed over the model group
before ``b_out``. No token all-to-all, as in the JAX package.

With telemetry enabled, ``zoo_moe_dropped_tokens_total{layer=...}`` grows
by n·k less the assigned slots (one host read a call); disabled, nothing
is read on the host. ``router_noise`` acts only when a generator is
given with ``training``: the graph does not hand this layer one, as the
JAX graph hands it no rng, so the noise never acts inside a model.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.profiler import record_function

from .....parallel.collectives import copy_to_region, reduce_from_region
from .....parallel.mesh import ambient_axis
from ..engine.base import KerasLayer, get_activation_fn, init_tensor


def top_k_gates(gates, k):
    """The k largest gates of each row and their experts, ties to the
    lower expert index (``jax.lax.top_k``'s order)."""
    w, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return w[:, :k], i[:, :k]


def capacity(n, k, e, capacity_factor):
    return max(1, int(math.ceil(k * n / e * capacity_factor)))


def assign_slots(top_i, n_experts, cap):
    """The JAX layer's capacity assignment as indices: for each (token,
    slot k) the flat expert slot ``expert * cap + position`` and whether
    it is within capacity, both (N, k). The running count is an
    expert-major (E, N) scan along its inner dim: a scan down the token
    axis of an (N, E) one-hot runs one thread a column on the card."""
    n, k = top_i.shape
    experts = torch.arange(n_experts, device=top_i.device)[:, None]
    used = torch.zeros(n_experts, 1, dtype=torch.int32, device=top_i.device)
    flat, kept = [], []
    for slot in range(k):                # k is small and static
        idx = top_i[:, slot]
        onehot = idx[None, :] == experts                          # (E, N)
        count = torch.cumsum(onehot, dim=1, dtype=torch.int32)
        pos = (count - 1 + used).gather(0, idx[None, :])[0].long()
        kept.append(pos < cap)
        flat.append(idx * cap + pos.clamp(max=cap - 1))
        used = used + count[:, -1:]
    return torch.stack(flat, 1), torch.stack(kept, 1)


class SparseMoE(KerasLayer):
    """Top-k gated mixture of expert MLPs. Input ``(B, L, H)`` (or
    ``(B, H)``); output the same shape."""

    # the stacked experts over expert, their hidden columns over model
    sharded_compute = {"expert": "expert", "mlp": "model"}

    def __init__(self, n_experts: int, intermediate_size: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 activation: str = "gelu", router_noise: float = 0.0,
                 input_shape=None, name: Optional[str] = None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        if top_k < 1 or top_k > n_experts:
            raise ValueError(f"top_k {top_k} out of range for "
                             f"{n_experts} experts")
        self.n_experts = n_experts
        self.intermediate_size = intermediate_size
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation = get_activation_fn(activation)
        self.router_noise = router_noise

    def build(self, generator, input_shape):
        h = int(input_shape[-1])
        e, f = self.n_experts, self.intermediate_size
        params = {
            "router_w": init_tensor(generator, (h, e)),
            "w_in": init_tensor(generator, (e, h, f)),
            "b_in": torch.zeros(e, f),
            "w_out": init_tensor(generator, (e, f, h)),
            "b_out": torch.zeros(e, h),
        }
        self._annotate(**{
            "router_w": ("embed", None),
            "w_in": ("expert", "embed", "mlp"),
            "b_in": ("expert", "mlp"),
            "w_out": ("expert", "mlp", "embed"),
            "b_out": ("expert", "embed"),
        })
        return params

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)

    def _params(self):
        return {k: getattr(self, k)
                for k in ("router_w", "w_in", "b_in", "w_out", "b_out")}

    # ------------------------------------------------------------------
    def route(self, p, flat, generator=None, training=False):
        """The float32 gates (N, E) of the token rows ``flat``."""
        logits = torch.matmul(flat, p["router_w"].to(flat.dtype))
        if training and self.router_noise > 0 and generator is not None:
            logits = logits + self.router_noise * torch.randn(
                logits.shape, generator=generator, device=logits.device,
                dtype=logits.dtype)
        return torch.softmax(logits.float(), dim=-1)

    def _local(self, p):
        """(expert group, first local expert, local experts, model
        group) of the weights ``p``: this rank's experts and the groups
        its parts sum over (None where the weights are whole)."""
        e_loc, f_loc = p["w_in"].shape[0], p["w_in"].shape[-1]
        ep = tp = None
        e0 = 0
        if e_loc != self.n_experts:
            ep, n, r = ambient_axis("expert")
            if n * e_loc != self.n_experts:
                raise ValueError(f"{e_loc} of {self.n_experts} experts do "
                                 f"not match the expert axis ({n} ranks)")
            e0 = r * e_loc
        if f_loc != self.intermediate_size:
            tp, n, _ = ambient_axis("model")
            if n * f_loc != self.intermediate_size:
                raise ValueError(f"{f_loc} of {self.intermediate_size} "
                                 f"hidden columns do not match the model "
                                 f"axis ({n} ranks)")
        return ep, e0, e_loc, tp

    def dispatch(self, p, x, training=False, generator=None):
        """The layer's output for ``x`` with the parameters ``p`` (a dict
        or a ``ParameterDict`` of the five tensors; this rank's experts
        under expert parallelism)."""
        orig_shape = x.shape
        h = orig_shape[-1]
        flat = x.reshape(-1, h)                       # (N, H)
        n = flat.shape[0]
        e, k = self.n_experts, self.top_k
        cap = capacity(n, k, e, self.capacity_factor)

        with record_function("moe/router"):
            gates = self.route(p, flat, generator, training)
            top_w, top_i = top_k_gates(gates, k)
            top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True),
                                        min=1e-9)
            slot, kept = assign_slots(top_i, e, cap)      # (N, k) each
        from .....utils import telemetry
        if telemetry.enabled():
            dropped = n * k - int(kept.sum())
            telemetry.counter("zoo_moe_dropped_tokens_total",
                              layer=self.name).inc(float(dropped))

        ep, e0, e_loc, tp = self._local(p)
        # every (token, slot) assignment in token-major order; a dropped
        # one (or, under expert parallelism, one of another rank's
        # experts) points at the spare slot e_loc * cap (a zero row of
        # h2) with weight 0, so no shape depends on the data (no host
        # sync)
        kept = kept.reshape(-1)
        slot = slot.reshape(-1) - e0 * cap
        if ep is not None:
            kept = kept & (slot >= 0) & (slot < e_loc * cap)
        slot = torch.where(kept, slot, e_loc * cap)
        weight = torch.where(kept, copy_to_region(top_w, ep).reshape(-1),
                             0.0)
        token = torch.arange(n, device=x.device).repeat_interleave(k)
        with record_function("moe/dispatch"):
            # the token each expert slot holds; an empty slot reads row
            # n, a zero row
            holder = torch.full((e_loc * cap + 1,), n, dtype=torch.int64,
                                device=x.device)
            holder[slot] = token
            padded = torch.cat([copy_to_region(flat, ep),
                                flat.new_zeros(1, h)])
            xin = padded.index_select(0, holder[:-1]).view(e_loc, cap, h)
        dt = x.dtype
        with record_function("moe/experts"):
            xin = copy_to_region(xin, tp)
            h1 = torch.baddbmm(p["b_in"].to(dt)[:, None], xin,
                               p["w_in"].to(dt))
            h1 = self.activation(h1)
            if tp is None:
                h2 = torch.baddbmm(p["b_out"].to(dt)[:, None], h1,
                                   p["w_out"].to(dt))
            else:
                h2 = reduce_from_region(torch.bmm(h1, p["w_out"].to(dt)),
                                        tp) + p["b_out"].to(dt)[:, None]
            h2 = h2.view(e_loc * cap, h)
        with record_function("moe/combine"):
            h2 = torch.cat([h2, h2.new_zeros(1, h)])
            contrib = h2.index_select(0, slot) * weight.to(dt)[:, None]
            out = flat.new_zeros(n, h).index_add(0, token, contrib)
            out = reduce_from_region(out, ep)
        return out.reshape(orig_shape)

    def forward(self, inputs, training=False, generator=None, **kw):
        x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        return self.dispatch(self._params(), x, training, generator)

    # ------------------------------------------------------------------
    def load_balancing_loss(self, x):
        """Switch-style aux loss ``E * sum_e f_e * p_e`` (the fraction of
        tokens whose top-1 is e times e's mean gate). The training engine
        never adds it to the loss, as in the JAX package."""
        x = x[0] if isinstance(x, (list, tuple)) else x
        gates = self.route(self._params(), x.reshape(-1, x.shape[-1]))
        top1 = torch.argmax(gates, dim=-1)
        frac = torch.nn.functional.one_hot(top1, self.n_experts).float() \
            .mean(0)
        return self.n_experts * torch.sum(frac * gates.mean(0))
