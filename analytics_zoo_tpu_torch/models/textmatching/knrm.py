"""KNRM: the Kernel-pooling Neural Ranking Model
(https://arxiv.org/abs/1706.06613).

Counterpart of ``analytics_zoo_tpu/models/textmatching/knrm.py``
(parity: ``KNRM.scala:30-105``). The input is the query's (text1) and
the document's (text2) token ids side by side, (batch, text1_length +
text2_length); the output (batch, 1). ``KernelPooling`` evaluates all K
RBF kernels at once over the (query x doc) translation matrix, one
batched matmul and one broadcast over a kernel axis, as the JAX layer
does (the reference chains ~100 autograd nodes, KNRM.scala:85-99).
"""

from __future__ import annotations

import numpy as np
import torch

from ...pipeline.api.keras.engine.base import KerasLayer
from ...pipeline.api.keras.layers import Dense, Embedding, Input
from ...pipeline.api.keras.models import Model
from .text_matcher import TextMatcher


class KernelPooling(KerasLayer):
    """RBF kernel pooling over the translation matrix. The kernel means
    follow KNRM.scala:86-92, ``mu_i = 1/(K-1) + 2i/(K-1) - 1``; the kernel
    whose mean exceeds 1 is clamped to exactly 1 with ``exact_sigma``
    (the exact-match kernel: ``exp(-0.5 d^2 / sigma^2)`` underflows to 0
    for every entry that is not an exact match)."""

    def __init__(self, text1_length, text2_length, kernel_num=21, sigma=0.1,
                 exact_sigma=0.001, name=None, **kwargs):
        super().__init__(name=name)
        if kernel_num <= 1:
            raise ValueError("kernel_num must be an integer greater than 1, "
                             f"got {kernel_num}")
        self.text1_length = int(text1_length)
        self.text2_length = int(text2_length)
        self.kernel_num = int(kernel_num)
        mus, sigmas = [], []
        for i in range(self.kernel_num):
            mu = 1.0 / (self.kernel_num - 1) + \
                (2.0 * i) / (self.kernel_num - 1) - 1.0
            if mu > 1.0:
                mus.append(1.0)
                sigmas.append(float(exact_sigma))
            else:
                mus.append(mu)
                sigmas.append(float(sigma))
        self.mus = np.asarray(mus, np.float32)
        self.sigmas = np.asarray(sigmas, np.float32)

    def forward(self, embed, training=False, **kw):
        # embed: (B, L1 + L2, E)
        l1 = self.text1_length
        mm = torch.bmm(embed[:, :l1], embed[:, l1:].transpose(1, 2))
        mus = torch.as_tensor(self.mus, dtype=embed.dtype,
                              device=embed.device)
        sigmas = torch.as_tensor(self.sigmas, dtype=embed.dtype,
                                 device=embed.device)
        d = mm[..., None] - mus                  # (B, L1, L2, K)
        k = torch.exp(-0.5 * d * d / (sigmas * sigmas))
        kde = torch.log1p(k.sum(dim=2))          # soft-TF: (B, L1, K)
        return kde.sum(dim=1)                    # (B, K)

    def compute_output_shape(self, s):
        return (s[0], self.kernel_num)


class KNRM(TextMatcher):
    """Arguments (KNRM.scala:37-58): text1_length, text2_length,
    vocab_size, embed_size, embed_weights (a pretrained table or None),
    train_embed, kernel_num (> 1), sigma, exact_sigma, target_mode
    'ranking' (Dense(1), trained with rank_hinge) or 'classification'
    (a sigmoid head)."""

    def __init__(self, text1_length, text2_length, vocab_size, embed_size=300,
                 embed_weights=None, train_embed=True, kernel_num=21,
                 sigma=0.1, exact_sigma=0.001, target_mode="ranking"):
        super().__init__(text1_length, vocab_size, embed_size, embed_weights,
                         train_embed, target_mode)
        self.text2_length = int(text2_length)
        self.kernel_num = int(kernel_num)
        self.sigma = float(sigma)
        self.exact_sigma = float(exact_sigma)
        self._record_config(
            text1_length=self.text1_length, text2_length=self.text2_length,
            vocab_size=self.vocab_size, embed_size=self.embed_size,
            train_embed=self.train_embed, kernel_num=self.kernel_num,
            sigma=self.sigma, exact_sigma=self.exact_sigma,
            target_mode=self.target_mode)
        self.model = self.build_model()

    def build_model(self):
        total = self.text1_length + self.text2_length
        inp = Input(shape=(total,))
        embed = Embedding(self.vocab_size, self.embed_size,
                          weights=self.embed_weights,
                          trainable=self.train_embed)(inp)
        phi = KernelPooling(self.text1_length, self.text2_length,
                            self.kernel_num, self.sigma,
                            self.exact_sigma)(embed)
        if self.target_mode == "ranking":
            out = Dense(1, init="uniform")(phi)
        else:
            out = Dense(1, init="uniform", activation="sigmoid")(phi)
        return Model(inp, out)
