"""GANEstimator — alternating generator/discriminator training.

Counterpart of ``analytics_zoo_tpu/tfpark/gan_estimator.py`` (parity:
``pyzoo/zoo/tfpark/gan/gan_estimator.py`` + ``GanOptimMethod``,
``zoo/.../tfpark/GanOptimMethod.scala:26``, which interleave d_steps/
g_steps inside the BigDL optimizer). Generator and discriminator are
zoo models; each update is its own step (loss → gradient of the side it
trains only → that side's optimizer, from ``get_optimizer``) driven by a
host loop, with the non-saturating GAN losses as defaults. The two
optimizer states are separate, and a step takes the gradient of its own
side's parameters alone (``torch.autograd.grad``), so neither side's
gradients reach the other's optimizer. Noise comes from a
``torch.Generator`` seeded from ``seed``, drawn in :meth:`noise`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..feature.feature_set import FeatureSet
from ..pipeline.api.keras.optimizers import get_optimizer
from .tf_dataset import TFDataset, _tensors_to_fs


def generator_loss_fn(fake_logits):
    """Non-saturating G loss: -log sigmoid(D(G(z)))."""
    return -torch.mean(F.logsigmoid(fake_logits))


def discriminator_loss_fn(real_logits, fake_logits):
    """-log sigmoid(D(x)) - log(1 - sigmoid(D(G(z))))."""
    return -torch.mean(F.logsigmoid(real_logits)) \
        - torch.mean(F.logsigmoid(-fake_logits))


class GANEstimator:
    """Alternating GAN optimization (gan_estimator.py parity), on the
    context's device at the first step (the card unless
    ``init_nncontext(device="cpu")``)."""

    def __init__(self, generator, discriminator,
                 generator_loss_fn: Callable = generator_loss_fn,
                 discriminator_loss_fn: Callable = discriminator_loss_fn,
                 generator_optimizer="adam",
                 discriminator_optimizer="adam",
                 noise_dim: int = 8,
                 d_steps: int = 1, g_steps: int = 1, seed: int = 0):
        self.generator = generator
        self.discriminator = discriminator
        self.g_loss_fn = generator_loss_fn
        self.d_loss_fn = discriminator_loss_fn
        self.g_opt = get_optimizer(generator_optimizer).transformation()
        self.d_opt = get_optimizer(discriminator_optimizer).transformation()
        self.noise_dim = noise_dim
        self.d_steps = d_steps
        self.g_steps = g_steps
        self.seed = seed
        self._built = False
        self._updates = 0
        self.steps = 0

    # ------------------------------------------------------------------
    def _build(self):
        if self._built:
            return
        from ..common.nncontext import get_nncontext

        self.device = get_nncontext().device
        for m in (self.generator, self.discriminator):
            m.graph_function()      # a Sequential builds its layers here
            m.to(self.device)
        self.g_params = dict(self.generator.named_parameters())
        self.d_params = dict(self.discriminator.named_parameters())
        with torch.no_grad():
            self.g_opt_state = self.g_opt.init(self.g_params)
            self.d_opt_state = self.d_opt.init(self.d_params)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(self.seed))
        self._built = True

    def noise(self, n: int) -> torch.Tensor:
        """(n, noise_dim) standard normal noise on the device."""
        self._build()
        return torch.randn((n, self.noise_dim), generator=self._gen,
                           device=self.device)

    def _dropout_gen(self) -> torch.Generator:
        """The dropout stream of the next update (seeded on the host: no
        device sync)."""
        from ..pipeline.engine import step_seed

        self._updates += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, self._updates))
        return gen

    def _g(self, noise, training, gen=None):
        return self.generator(noise, training=training, generator=gen)

    def _d(self, x, gen=None):
        return self.discriminator(x, training=True, generator=gen)

    @staticmethod
    def _apply(opt, params, state, loss):
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            updates, state = opt.update(dict(zip(params, grads)), state,
                                        params)
            for k, p in params.items():
                p.add_(updates[k].to(p.dtype))
        return state

    def d_step(self, real, noise, gen=None) -> torch.Tensor:
        """One discriminator update on a real batch and noise; returns
        its loss. The generator's parameters take no gradient."""
        self._build()
        with torch.no_grad():
            fake = self._g(noise, True, gen)
        loss = self.d_loss_fn(self._d(real, gen), self._d(fake, gen))
        self.d_opt_state = self._apply(self.d_opt, self.d_params,
                                       self.d_opt_state, loss)
        return loss.detach()

    def g_step(self, noise, gen=None) -> torch.Tensor:
        """One generator update on noise; returns its loss. The
        discriminator's parameters take no gradient."""
        self._build()
        loss = self.g_loss_fn(self._d(self._g(noise, True, gen), gen))
        self.g_opt_state = self._apply(self.g_opt, self.g_params,
                                       self.g_opt_state, loss)
        return loss.detach()

    # ------------------------------------------------------------------
    def train(self, data, end_trigger=None, steps: Optional[int] = None,
              batch_size: int = 32) -> "GANEstimator":
        if isinstance(data, TFDataset):
            fs, batch_size = data.feature_set, data.batch_size
        elif isinstance(data, FeatureSet):
            fs = data
        else:
            fs = _tensors_to_fs(data)
        self._build()
        if len(fs) < batch_size:
            raise ValueError(
                f"dataset of {len(fs)} samples is smaller than "
                f"batch_size={batch_size}")
        max_steps = steps
        if max_steps is None and end_trigger is not None:
            if getattr(end_trigger, "max_iteration", None) is not None:
                max_steps = end_trigger.max_iteration
            elif getattr(end_trigger, "max_epoch", None) is not None:
                max_steps = end_trigger.max_epoch * max(
                    1, len(fs) // batch_size)
        if max_steps is None:
            max_steps = 1000
        step = 0
        epoch = 0
        g_loss = d_loss = torch.tensor(float("nan"))
        while step < max_steps:
            for batch in fs.batches(batch_size, shuffle=True,
                                    drop_remainder=True,
                                    seed=self.seed + epoch):
                if step >= max_steps:
                    break
                real = batch.inputs[0] if isinstance(
                    batch.inputs, (list, tuple)) else batch.inputs
                real = torch.as_tensor(np.asarray(real, np.float32),
                                       device=self.device)
                for _ in range(self.d_steps):
                    d_loss = self.d_step(real, self.noise(real.shape[0]),
                                         self._dropout_gen())
                for _ in range(self.g_steps):
                    g_loss = self.g_step(self.noise(real.shape[0]),
                                         self._dropout_gen())
                step += 1
                self.steps += 1
            epoch += 1
        self.last_losses: Dict[str, float] = {"g": float(g_loss),
                                              "d": float(d_loss)}
        return self

    def generate(self, n: int = 16, noise=None):
        self._build()
        noise = self.noise(n) if noise is None else torch.as_tensor(
            np.asarray(noise, np.float32), device=self.device)
        with torch.no_grad():
            out = self._g(noise, False)
        return out.float().cpu().numpy()
