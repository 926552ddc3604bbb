"""Embedding layers.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
embeddings.py`` (parity: Embedding.scala, SparseEmbedding.scala). The
lookup keeps ``jnp.take``'s semantics: ids arrive as ``x.to(int32)`` of
whatever dtype comes in (floats truncate toward zero; bf16 ids have
already rounded above 256), an id in [-n, -1] counts from the end, and an
id outside [-n, n) gives a row of NaN instead of an error. The gather
reads a clamped index, so an out-of-range id never reaches the device as
an index: no host error on the CPU and no device-side assert on the
card. An out-of-range row gets no gradient, as in JAX's scatter-add.

Under a bf16 (or float16) table that takes a gradient, the rows are
gathered from the table's float32 values and cast back, so the forward is
the same and the backward's scatter-add sums the duplicate ids in
float32: PyTorch's ``index_put_`` backward adds each duplicate into a
tensor of the table's dtype, and in bf16 thousands of additions into one
row round at every step (BERT's 2-row segment table at batch 32 x 512
lost a third of its gradient's norm; ROADMAP C6).

``WordEmbedding`` (frozen GloVe vectors) is not ported yet: it needs a
GloVe file, which the repository does not hold.
"""

from __future__ import annotations

import torch

from ..engine.base import KerasLayer, init_tensor


def take_rows(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, x.astype(int32), axis=0)``: rows of ``table`` for
    the ids ``x``, NaN rows for ids outside [-n, n)."""
    n = table.shape[0]
    idx = x.to(torch.int32).long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    if table.dtype in (torch.bfloat16, torch.float16) and \
            table.requires_grad and torch.is_grad_enabled():
        rows = table.float()[idx.clamp(0, n - 1)].to(table.dtype)
    else:
        rows = table[idx.clamp(0, n - 1)]
    return torch.where(valid[..., None], rows,
                       torch.full((), float("nan"), dtype=rows.dtype,
                                  device=rows.device))


class Embedding(KerasLayer):
    """A trainable (input_dim, output_dim) ``table``; (..., ) ids ->
    (..., output_dim) rows."""

    def __init__(self, input_dim, output_dim, init="uniform", weights=None,
                 trainable=True, input_length=None, W_regularizer=None,
                 input_shape=None, name=None, **kwargs):
        if input_shape is None and input_length is not None:
            input_shape = (input_length,)
        super().__init__(input_shape=input_shape, name=name)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.init = init
        self.weights = weights
        self.trainable = trainable

    def build(self, generator, input_shape):
        if self.weights is not None:
            table = torch.as_tensor(self.weights, dtype=torch.float32)
            if tuple(table.shape) != (self.input_dim, self.output_dim):
                raise ValueError(f"weights {tuple(table.shape)} do not "
                                 f"match ({self.input_dim}, "
                                 f"{self.output_dim})")
            table = table.clone()
        else:
            table = init_tensor(generator, (self.input_dim, self.output_dim),
                                self.init)
        return {"table": table}

    def forward(self, x, training=False, **kw):
        table = self.table if self.trainable else self.table.detach()
        return take_rows(table, x)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class SparseEmbedding(Embedding):
    """The reference's SparseEmbedding backs sparse-gradient updates
    (SparseEmbedding.scala); as in the JAX package, an alias of
    :class:`Embedding` with the same construction surface (the gather's
    backward is a dense index-add)."""
