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

``WordEmbedding`` (pretrained GloVe vectors, WordEmbedding.scala) keeps
its table a parameter, as the JAX layer does: frozen (``trainable=False``,
the default) it is read through ``detach`` where JAX reads it through
``stop_gradient``, so it takes a zero gradient, stays in the optimizer's
state and in a checkpoint's leaves, and does not move.
"""

from __future__ import annotations

import numpy as np
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
        self._annotate(table=("vocab", "embed"))
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


class WordEmbedding(KerasLayer):
    """Pretrained word embeddings (WordEmbedding.scala): the ``table``
    from ``weights`` (a (vocab, dim) array) or from a GloVe-format
    ``embedding_file`` (one ``word v1 ... vd`` line a word) over
    ``word_index`` ({word: row}; the file's order from row 1 when None;
    row 0 and the words the file lacks stay zero)."""

    def __init__(self, embedding_file=None, word_index=None, trainable=False,
                 input_length=None, weights=None, input_shape=None, name=None,
                 **kwargs):
        if input_shape is None and input_length is not None:
            input_shape = (input_length,)
        super().__init__(input_shape=input_shape, name=name)
        self.trainable = trainable
        if weights is not None:
            self.table_init = np.asarray(weights, np.float32)
        elif embedding_file is not None:
            self.table_init = _load_glove_table(embedding_file, word_index)
        else:
            raise ValueError("need weights or embedding_file")
        self.output_dim = self.table_init.shape[1]

    def build(self, generator, input_shape):
        return {"table": torch.from_numpy(self.table_init.copy())}

    def forward(self, x, training=False, **kw):
        table = self.table if self.trainable else self.table.detach()
        return take_rows(table, x)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)

    @staticmethod
    def get_word_index(embedding_file):
        """{word: 1-based line number} of a GloVe-format file."""
        index = {}
        with open(embedding_file, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                index[line.split(" ", 1)[0]] = i + 1
        return index


def _load_glove_table(path, word_index=None):
    vectors = {}
    dim = None
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            vectors[parts[0]] = np.asarray(parts[1:], np.float32)
            dim = len(parts) - 1
    if word_index is None:
        word_index = {w: i + 1 for i, w in enumerate(vectors)}
    table = np.zeros((max(word_index.values()) + 1, dim), np.float32)
    for word, idx in word_index.items():
        if word in vectors:
            table[idx] = vectors[word]
    return table
