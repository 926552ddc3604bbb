"""Optimizers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/optimizers.py``.
The JAX package lowers each optimizer to an optax chain; this module
carries the same chains as functional updates over the parameter dict
(``{name: tensor}``), so the steps are optax's and not ``torch.optim``'s
defaults:

- :class:`Adam` is ``scale_by_adam`` (bias-corrected moments, eps outside
  the square root, ``eps_root=0``, the count starting at 0) then the
  learning rate;
- :class:`SGD` chains decayed weights, then the momentum trace (nesterov
  optional), then the learning rate; ``dampening`` is accepted and
  ignored, as in the JAX package;
- :class:`AdamWeightDecay` is adam, then decayed weights, then the
  learning rate;
- :class:`RMSprop` is ``scale_by_rms`` (eps inside the square root, the
  accumulator from 0, no bias correction), not ``torch.optim.RMSprop``;
- :class:`Adagrad` is ``scale_by_rss`` (the accumulator from 0.1, eps
  inside the square root), not ``torch.optim.Adagrad``;
- :class:`Adadelta` is ``scale_by_adadelta`` and :class:`Adamax`
  ``scale_by_adamax`` (eps added to |g| inside the max);
- :class:`Ftrl` is the JAX package's stand-in: ``scale_by_rss`` at its
  defaults, as Adagrad, and its own arguments unused;
- ``clipvalue`` and ``clipnorm`` come first in the chain, the learning
  rate is ``schedule(count)`` (``decay`` gives ``lr / (1 + decay * count)``)
  with its own step count from 0.

Each transformation's ``update`` returns new update tensors and updates
its state tensors in place (the moments are as large as the model; a copy
per step would double that memory).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() * t.float()).sum()
                          for t in tree.values()))


# ---------------------------------------------------------------------------
# gradient transformations (the optax pieces the optimizers chain)
# ---------------------------------------------------------------------------

class Transformation:
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``, over dicts keyed like the parameters."""

    def init(self, params: Params):
        return None

    def update(self, grads: Params, state, params: Params):
        raise NotImplementedError


class Chain(Transformation):
    def __init__(self, *transforms: Transformation):
        self.transforms = list(transforms)

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def update(self, grads, state, params):
        new_state = []
        for t, s in zip(self.transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, new_state


class Clip(Transformation):
    """Each element clipped to [-max_delta, max_delta] (``optax.clip``)."""

    def __init__(self, max_delta: float):
        self.max_delta = max_delta

    def update(self, grads, state, params):
        return {k: torch.clamp(g, -self.max_delta, self.max_delta)
                for k, g in grads.items()}, state


class ClipByGlobalNorm(Transformation):
    """Scaled by max_norm / global_norm when the norm reaches max_norm
    (``optax.clip_by_global_norm``)."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def update(self, grads, state, params):
        g_norm = global_norm(grads)
        keep = g_norm < self.max_norm
        return {k: torch.where(keep, g, (g / g_norm.to(g.dtype)) *
                               self.max_norm)
                for k, g in grads.items()}, state


class ScaleByAdam(Transformation):
    """``optax.scale_by_adam``: mu = b1 mu + (1 - b1) g,
    nu = b2 nu + (1 - b2) g^2, u = mu_hat / (sqrt(nu_hat) + eps) with the
    bias corrections at count + 1."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads, state, params):
        count = state["count"] + 1
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        updates = {}
        for k, g in grads.items():
            mu = state["mu"][k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu = state["nu"][k].mul_(self.b2).add_(g * g,
                                                  alpha=1.0 - self.b2)
            updates[k] = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
        state["count"] = count
        return updates, state


class ScaleByRms(Transformation):
    """``optax.scale_by_rms``: nu = decay nu + (1 - decay) g^2 from 0,
    u = g / sqrt(nu + eps)."""

    def __init__(self, decay=0.9, eps=1e-8):
        self.decay, self.eps = decay, eps

    def init(self, params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(self, grads, state, params):
        updates = {}
        for k, g in grads.items():
            nu = state[k].mul_(self.decay).add_(g * g, alpha=1.0 - self.decay)
            updates[k] = g * torch.rsqrt(nu + self.eps)
        return updates, state


class ScaleByRss(Transformation):
    """``optax.scale_by_rss``: s = s + g^2 from ``initial_accumulator_value``,
    u = g / sqrt(s + eps) (0 where s is 0)."""

    def __init__(self, initial_accumulator_value=0.1, eps=1e-7):
        self.initial, self.eps = initial_accumulator_value, eps

    def init(self, params):
        return {k: torch.full_like(p, self.initial)
                for k, p in params.items()}

    def update(self, grads, state, params):
        updates = {}
        for k, g in grads.items():
            s = state[k].add_(g * g)
            updates[k] = torch.where(s > 0, torch.rsqrt(s + self.eps),
                                     torch.zeros_like(s)) * g
        return updates, state


class ScaleByAdadelta(Transformation):
    """``optax.scale_by_adadelta``: e_g = rho e_g + (1 - rho) g^2,
    u = sqrt(e_x + eps) / sqrt(e_g + eps) g, then
    e_x = rho e_x + (1 - rho) u^2."""

    def __init__(self, rho=0.9, eps=1e-6):
        self.rho, self.eps = rho, eps

    def init(self, params):
        return {"e_g": {k: torch.zeros_like(p) for k, p in params.items()},
                "e_x": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads, state, params):
        updates = {}
        for k, g in grads.items():
            e_g = state["e_g"][k].mul_(self.rho).add_(g * g,
                                                     alpha=1.0 - self.rho)
            e_x = state["e_x"][k]
            u = torch.sqrt(e_x + self.eps) / torch.sqrt(e_g + self.eps) * g
            e_x.mul_(self.rho).add_(u * u, alpha=1.0 - self.rho)
            updates[k] = u
        return updates, state


class ScaleByAdamax(Transformation):
    """``optax.scale_by_adamax``: mu = b1 mu + (1 - b1) g,
    nu = max(|g| + eps, b2 nu), u = mu_hat / nu with mu's bias correction
    at count + 1."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads, state, params):
        count = state["count"] + 1
        c1 = 1.0 - self.b1 ** count
        updates = {}
        for k, g in grads.items():
            mu = state["mu"][k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu = state["nu"][k]
            torch.maximum(g.abs() + self.eps, nu * self.b2, out=nu)
            updates[k] = (mu / c1) / nu
        state["count"] = count
        return updates, state


class AddDecayedWeights(Transformation):
    """g + weight_decay * p (``optax.add_decayed_weights``)."""

    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def update(self, grads, state, params):
        return {k: g + self.weight_decay * params[k]
                for k, g in grads.items()}, state


class Trace(Transformation):
    """Momentum (``optax.trace``): t = g + decay * t; the update is t, or
    g + decay * t with nesterov."""

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov

    def init(self, params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(self, grads, state, params):
        updates = {}
        for k, g in grads.items():
            t = state[k].mul_(self.decay).add_(g)
            updates[k] = g + self.decay * t if self.nesterov else t
        return updates, state


class ScaleByLearningRate(Transformation):
    """u * -schedule(count), the count from 0 (``optax.
    scale_by_learning_rate`` over a schedule)."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def init(self, params):
        return {"count": 0}

    def update(self, grads, state, params):
        step_size = -float(self.schedule(state["count"]))
        state["count"] += 1
        return {k: g * step_size for k, g in grads.items()}, state


# ---------------------------------------------------------------------------
# learning-rate schedules: step count -> learning rate
# ---------------------------------------------------------------------------

class Schedule:
    def schedule_fn(self, base_lr: float) -> Callable[[int], float]:
        raise NotImplementedError


class Default(Schedule):
    def schedule_fn(self, base_lr):
        return lambda step: base_lr


class Plateau(Schedule):
    """A constant, as in the JAX package (plateau detection is not
    automatic there either)."""

    def schedule_fn(self, base_lr):
        return lambda step: base_lr


def polynomial_schedule(init_value, end_value, power, transition_steps):
    """``optax.polynomial_schedule`` with ``transition_begin=0``."""
    if transition_steps <= 0:
        return lambda step: init_value

    def schedule(step):
        count = min(max(step, 0), transition_steps)
        frac = 1.0 - count / transition_steps
        return (init_value - end_value) * frac ** power + end_value

    return schedule


class PolyEpochDecay(Schedule):
    def __init__(self, power: float, max_epochs: int,
                 iters_per_epoch: int = 1):
        self.power = power
        self.max_iters = max_epochs * iters_per_epoch

    def schedule_fn(self, base_lr):
        return polynomial_schedule(base_lr, 0.0, self.power, self.max_iters)


class Warmup(Schedule):
    def __init__(self, delta: float):
        self.delta = delta

    def schedule_fn(self, base_lr):
        return lambda step: base_lr + step * self.delta


def linear_onecycle_schedule(transition_steps, peak_value, pct_start=0.3,
                             pct_final=0.85, div_factor=25.0,
                             final_div_factor=1e4):
    """``optax.linear_onecycle_schedule``: piecewise linear between the
    cumulative products of the boundary scales."""
    if transition_steps <= 0:
        raise ValueError("a linear onecycle schedule needs positive "
                         "transition_steps")
    marks = {int(pct_start * transition_steps): div_factor,
             int(pct_final * transition_steps): 1.0 / div_factor,
             transition_steps: 1.0 / final_div_factor}
    bounds = [0] + sorted(marks)
    values = np.cumprod([peak_value / div_factor] +
                        [marks[b] for b in sorted(marks)])

    def schedule(step):
        for i in range(len(bounds) - 1):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                return float((values[i + 1] - values[i]) * pct + values[i])
        return float(values[-1])

    return schedule


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

class ZooOptimizer:
    """Base optimizer: Keras-style args -> a :class:`Transformation`."""

    def __init__(self, lr: float = 1e-3, schedule: Optional[Schedule] = None,
                 decay: float = 0.0, clipnorm: Optional[float] = None,
                 clipvalue: Optional[float] = None):
        self.lr = lr
        self.schedule = schedule
        self.decay = decay
        self.clipnorm = clipnorm
        self.clipvalue = clipvalue

    def _core(self, lr_schedule) -> Transformation:
        raise NotImplementedError

    def lr_schedule(self) -> Callable[[int], float]:
        if self.schedule is not None:
            return self.schedule.schedule_fn(self.lr)
        if self.decay > 0:
            return lambda step: self.lr / (1.0 + self.decay * step)
        return lambda step: self.lr

    def transformation(self) -> Transformation:
        chain: List[Transformation] = []
        if self.clipvalue is not None:
            chain.append(Clip(self.clipvalue))
        if self.clipnorm is not None:
            chain.append(ClipByGlobalNorm(self.clipnorm))
        chain.append(self._core(self.lr_schedule()))
        return Chain(*chain) if len(chain) > 1 else chain[0]

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


class SGD(ZooOptimizer):
    def __init__(self, lr=0.01, momentum=0.0, dampening=0.0, nesterov=False,
                 weight_decay=0.0, **kw):
        super().__init__(lr=lr, **kw)
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def _core(self, sched):
        chain: List[Transformation] = []
        if self.weight_decay > 0:
            chain.append(AddDecayedWeights(self.weight_decay))
        if self.momentum > 0:
            chain.append(Trace(self.momentum, self.nesterov))
        chain.append(ScaleByLearningRate(sched))
        return Chain(*chain)


class Adam(ZooOptimizer):
    """Adam with a pluggable schedule (keras/optimizers/Adam.scala)."""

    def __init__(self, lr=1e-3, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 schedule=None, **kw):
        super().__init__(lr=lr, schedule=schedule, **kw)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon

    def _core(self, sched):
        return Chain(ScaleByAdam(self.beta_1, self.beta_2, self.epsilon),
                     ScaleByLearningRate(sched))


class AdamWeightDecay(ZooOptimizer):
    """BERT-style AdamW (keras/optimizers/AdamWeightDecay.scala). With
    ``total > 0`` the learning rate follows the linear one-cycle schedule
    over ``total`` steps, the branch the JAX package takes with the optax
    it runs on (which has no ``warmup_linear_schedule``), so
    ``warmup_portion`` is unused there and here."""

    def __init__(self, lr=1e-3, warmup_portion=-1.0, total=-1,
                 schedule="linear", beta_1=0.9, beta_2=0.999, epsilon=1e-6,
                 weight_decay=0.01, **kw):
        super().__init__(lr=lr, **kw)
        self.warmup_portion = warmup_portion
        self.total = total
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def lr_schedule(self):
        if self.total <= 0:
            return lambda step: self.lr
        return linear_onecycle_schedule(self.total, self.lr)

    def _core(self, sched):
        return Chain(ScaleByAdam(self.beta_1, self.beta_2, self.epsilon),
                     AddDecayedWeights(self.weight_decay),
                     ScaleByLearningRate(sched))


class RMSprop(ZooOptimizer):
    def __init__(self, lr=0.001, decay_rate=0.9, epsilon=1e-8, **kw):
        super().__init__(lr=lr, **kw)
        self.decay_rate = decay_rate
        self.epsilon = epsilon

    def _core(self, sched):
        return Chain(ScaleByRms(self.decay_rate, self.epsilon),
                     ScaleByLearningRate(sched))


class Adagrad(ZooOptimizer):
    def __init__(self, lr=0.01, epsilon=1e-10, **kw):
        super().__init__(lr=lr, **kw)
        self.epsilon = epsilon

    def _core(self, sched):
        return Chain(ScaleByRss(eps=self.epsilon),
                     ScaleByLearningRate(sched))


class Adadelta(ZooOptimizer):
    def __init__(self, lr=1.0, rho=0.95, epsilon=1e-8, **kw):
        super().__init__(lr=lr, **kw)
        self.rho = rho
        self.epsilon = epsilon

    def _core(self, sched):
        return Chain(ScaleByAdadelta(self.rho, self.epsilon),
                     ScaleByLearningRate(sched))


class Adamax(ZooOptimizer):
    def __init__(self, lr=0.002, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 **kw):
        super().__init__(lr=lr, **kw)
        self.beta_1, self.beta_2, self.epsilon = beta_1, beta_2, epsilon

    def _core(self, sched):
        return Chain(ScaleByAdamax(self.beta_1, self.beta_2, self.epsilon),
                     ScaleByLearningRate(sched))


class Ftrl(ZooOptimizer):
    """The JAX package's stand-in for FTRL (optax has none): Adagrad-style
    scaling at ``scale_by_rss``'s defaults. The FTRL arguments are taken
    and unused there, and here."""

    def __init__(self, lr=0.001, learning_rate_power=-0.5,
                 initial_accumulator_value=0.1, l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0, **kw):
        super().__init__(lr=lr, **kw)

    def _core(self, sched):
        return Chain(ScaleByRss(), ScaleByLearningRate(sched))


_OPTIMIZERS = {
    "sgd": SGD,
    "adam": Adam,
    "adamax": Adamax,
    "rmsprop": RMSprop,
    "adadelta": Adadelta,
    "adagrad": Adagrad,
    "adamweightdecay": AdamWeightDecay,
    "ftrl": Ftrl,
}


def get_optimizer(identifier) -> ZooOptimizer:
    if isinstance(identifier, ZooOptimizer):
        return identifier
    try:
        return _OPTIMIZERS[identifier.lower()]()
    except KeyError:
        raise ValueError(f"Unknown optimizer: {identifier}")
