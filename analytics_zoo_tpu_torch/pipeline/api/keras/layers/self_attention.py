"""TransformerLayer and BERT.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/layers/
self_attention.py`` (parity surface ``TransformerLayer.scala``: GPT-style
post-LN blocks with tanh GELU; ``BERT.scala``: four inputs, erf GELU,
extended mask ``(1 - mask) * -10000``).

One layer owns every block's parameters, in the JAX layout
(``block{i}.qkv_w`` (h, 3h), ...). The training and serving forward
looks its ids up with ``jnp.take``'s semantics (``take_rows``: ids cast
to int32, a NaN row for an id out of range, no device-side assert), so
bf16's rounding of float ids (ROADMAP C4) gives what the JAX layer gives.
Attention goes through
``ops.attention.flash_attention_blhd`` on the (B, L, H, d) reshape of the
fused QKV projection — strided views, no copy — which launches the CUDA
flash-attention forward kernel on the GPU, and in training its backward
kernels. Both residual sites run ``dropout_add_layer_norm``, the fused
dropout + add + layer-norm kernels in training.

Training draws all of a forward's dropout from one ``torch.Generator`` on
the activations' device, in order: the embedding dropout, then in each
block the attention-output dropout and the two residual sites' 32-bit
words. JAX splits its key the same way (embedding first, then per block
attention / ln1 / ln2, ``call`` :650-666 and ``_block`` :386-393); the
streams differ by design.

KV-cache decoding (``init_decode_state``, ``prefill``, ``decode_step``,
``decode_chunk``, ``lm_logits`` over ``ops/kv_cache.py``) keeps the JAX
signatures less their ``params`` argument, since the layer owns its
weights. ``prefill`` runs every block's attention through the causal
flash route with a (B, 1, 1, Lp) -1e9 padding key bias, which on the GPU
is the CUDA flash-attention forward kernel; the decode steps attend
against the slabs in plain torch, as the JAX package does in ``jnp``.
The decode methods run without autograd and write the state's slabs in
place.

Not ported yet, and raising ``NotImplementedError`` when asked for: the
sequence-parallel, data-parallel and pipeline-parallel (GPipe) branches
(the multi-GPU slice), the MoE feed-forward (the layer-library slice) and
a custom ``embedding_layer``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .....ops import kv_cache
from .....ops.attention import flash_attention_blhd
from .....ops.fused_dropout_ln import dropout_add_layer_norm
from .....ops.layernorm import layer_norm
from ..engine.base import KerasLayer
from .embeddings import take_rows

_MULTI_GPU = "the multi-GPU slice of the port"


def _normal(generator, shape, std):
    return std * torch.randn(shape, generator=generator)


def _dropout(x, p, generator, training):
    """Inverted dropout with a Bernoulli keep-mask drawn from
    ``generator`` (the embedding and attention-output sites)."""
    if not training or generator is None or p <= 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def _parallel_degree(field: str) -> int:
    """A parallel degree from the ambient context's config (1 without a
    context). Peeks the global context without creating one."""
    from .....common import nncontext as _nn
    ctx = _nn._global_context
    if ctx is None:
        return 1
    return int(getattr(ctx.config, field, 1))


class TransformerLayer(KerasLayer):
    """GPT-style transformer stack.

    Inputs: token ids ``(B, L)`` as floats (positions are implicit
    arange). Outputs ``(sequence_states, pooled)`` (or all block states +
    pooled when ``output_all_block``)."""

    stochastic = True
    gelu_approximate = True  # TransformerLayer.scala uses the tanh approx

    def __init__(self, n_block, hidden_p_drop=0.1, attn_p_drop=0.1,
                 n_head=12, initializer_range=0.02, bidirectional=False,
                 output_all_block=False, intermediate_size=0,
                 vocab=40990, seq_len=77, hidden_size=768,
                 embedding_layer=None, moe_experts=0, moe_top_k=2,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
        if embedding_layer is not None:
            raise NotImplementedError(
                "TransformerLayer(embedding_layer=...) is not ported yet; "
                "it arrives with the layer-library slice of the port")
        if moe_experts:
            raise NotImplementedError(
                "TransformerLayer(moe_experts>0) is not ported yet; the MoE "
                "feed-forward arrives with the layer-library slice")
        self.n_block = int(n_block)
        self.n_head = int(n_head)
        self.hidden_p_drop = hidden_p_drop
        self.attn_p_drop = attn_p_drop
        self.initializer_range = initializer_range
        self.bidirectional = bidirectional
        self.output_all_block = output_all_block
        self.vocab = int(vocab)
        self.seq_len = int(seq_len)
        self.hidden_size = int(hidden_size)
        self.intermediate_size = int(intermediate_size) or \
            4 * self.hidden_size
        if self.hidden_size % self.n_head:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of n_head {self.n_head}")
        self.num_outputs = (self.n_block if output_all_block else 1) + 1

    # -- params --------------------------------------------------------
    def _embedding_params(self, generator):
        return {
            "tok_emb": _normal(generator, (self.vocab, self.hidden_size),
                               self.initializer_range),
            "pos_emb": _normal(generator, (self.seq_len, self.hidden_size),
                               self.initializer_range),
        }

    def _block_params(self, generator):
        h = self.hidden_size
        m = self.intermediate_size
        std = self.initializer_range
        return {
            "qkv_w": _normal(generator, (h, 3 * h), std),
            "qkv_b": torch.zeros(3 * h),
            "proj_w": _normal(generator, (h, h), std),
            "proj_b": torch.zeros(h),
            "ln1_g": torch.ones(h), "ln1_b": torch.zeros(h),
            "ln2_g": torch.ones(h), "ln2_b": torch.zeros(h),
            "mlp_in_w": _normal(generator, (h, m), std),
            "mlp_in_b": torch.zeros(m),
            "mlp_out_w": _normal(generator, (m, h), std),
            "mlp_out_b": torch.zeros(h),
        }

    def build(self, generator, input_shape):
        if _parallel_degree("pipeline_parallel") > 1:
            raise NotImplementedError(
                "pipeline_parallel > 1 (the GPipe stacked-block layout) is "
                f"not ported yet; it arrives with {_MULTI_GPU}")
        params = self._embedding_params(generator)
        for i in range(self.n_block):
            params[f"block{i}"] = self._block_params(generator)
        params["pooler_w"] = _normal(generator,
                                     (self.hidden_size, self.hidden_size),
                                     self.initializer_range)
        params["pooler_b"] = torch.zeros(self.hidden_size)
        return params

    # -- compute -------------------------------------------------------
    def _ln(self, x, g, b, eps=1e-5):
        return layer_norm(x, g, b, eps)

    def _gelu(self, x):
        return F.gelu(x, approximate="tanh" if self.gelu_approximate
                      else "none")

    def _attention(self, p, x, mask_bias, generator, training):
        b, l, h = x.shape
        nh = self.n_head
        d = h // nh
        if _parallel_degree("sequence_parallel") > 1:
            raise NotImplementedError(
                "sequence parallelism (ring / ulysses attention) is not "
                f"ported yet; it arrives with {_MULTI_GPU}")
        if _parallel_degree("data_parallel") > 1:
            raise NotImplementedError(
                "the data-parallel attention wrap is not ported yet; it "
                f"arrives with {_MULTI_GPU}")
        qkv = torch.matmul(x, p["qkv_w"].to(x.dtype)) + \
            p["qkv_b"].to(x.dtype)
        q, k, v = qkv.split(h, dim=-1)
        # (B, L, H, d) views of the fused projection feed the kernel
        # directly: no [B, H, L, d] relayout copies in, none out
        q4, k4, v4 = (t.reshape(b, l, nh, d) for t in (q, k, v))
        o = flash_attention_blhd(q4, k4, v4, bias=mask_bias,
                                 causal=not self.bidirectional)
        o = o.reshape(b, l, h)
        o = _dropout(o, self.attn_p_drop, generator, training)
        return torch.matmul(o, p["proj_w"].to(x.dtype)) + \
            p["proj_b"].to(x.dtype)

    def _block(self, p, x, mask_bias, generator, training):
        a = self._attention(p, x, mask_bias, generator, training)
        n = dropout_add_layer_norm(a, x, p["ln1_g"], p["ln1_b"], generator,
                                   self.hidden_p_drop, training)
        m = self._ffn(p, n, training)
        return dropout_add_layer_norm(m, n, p["ln2_g"], p["ln2_b"],
                                      generator, self.hidden_p_drop,
                                      training)

    def _ffn(self, p, n, training):
        m = torch.matmul(n, p["mlp_in_w"].to(n.dtype)) + \
            p["mlp_in_b"].to(n.dtype)
        m = self._gelu(m)
        return torch.matmul(m, p["mlp_out_w"].to(n.dtype)) + \
            p["mlp_out_b"].to(n.dtype)

    def _embed(self, inputs):
        tokens = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        e = take_rows(self.tok_emb, tokens)
        e = e + self.pos_emb[None, :e.shape[1]]
        return e, None

    def _pooler(self, x):
        first = x[:, 0]
        return torch.tanh(torch.matmul(first, self.pooler_w.to(x.dtype)) +
                          self.pooler_b.to(x.dtype))

    def forward(self, inputs, training=False, generator=None, **kw):
        e, mask_bias = self._embed(inputs)
        e = _dropout(e, self.hidden_p_drop, generator, training)
        states = []
        x = e
        for i in range(self.n_block):
            x = self._block(getattr(self, f"block{i}"), x, mask_bias,
                            generator, training)
            states.append(x)
        pooled = self._pooler(x)
        if self.output_all_block:
            return tuple(states) + (pooled,)
        return (x, pooled)

    # -- KV-cache incremental decode (ops/kv_cache.py) -----------------
    #
    # The generative-serving path: prefill runs the prompt once through
    # the causal flash route and stashes every block's projected K/V into
    # preallocated slabs; decode_step then advances one token per call
    # with O(S) cached attention. Decode is inference-only: no dropout,
    # no autograd. The pipeline-parallel stacked-block layout the JAX
    # method refuses cannot be built here (``build`` raises).

    def _require_decode_layout(self):
        if self.bidirectional:
            raise ValueError(
                "KV-cache decode needs a causal trunk; this layer was "
                "built bidirectional (BERT-style)")

    def init_decode_state(self, batch, capacity, dtype=torch.float32,
                          rng=None):
        """Preallocate (B, S, H, D) K/V slabs for every block on the
        layer's device. ``dtype="int8"`` allocates quantized
        ``Int8KVSlab`` slabs; the cache ops dequantize inside the
        attention einsums, so prefill / decode_step / decode_chunk run
        unchanged."""
        return kv_cache.init_decode_state(
            self.n_block, batch, capacity, self.n_head,
            self.hidden_size // self.n_head, dtype=dtype, rng=rng,
            device=self.tok_emb.device)

    def lm_logits(self, x):
        """Token logits via embedding weight tying: x @ tok_emb^T."""
        return torch.matmul(x, self.tok_emb.T.to(x.dtype))

    def _decode_block(self, p, x, attend):
        """One block of a decode call: the fused QKV projection, the
        given attention over (B, C, H, d) views, then the output
        projection, the composed add + LN sites and the FFN."""
        b, c, h = x.shape
        nh = self.n_head
        qkv = torch.matmul(x, p["qkv_w"].to(x.dtype)) + \
            p["qkv_b"].to(x.dtype)
        q, k, v = (t.reshape(b, c, nh, h // nh)
                   for t in qkv.split(h, dim=-1))
        o = attend(q, k, v)
        a = torch.matmul(o.reshape(b, c, h), p["proj_w"].to(x.dtype)) + \
            p["proj_b"].to(x.dtype)
        n = dropout_add_layer_norm(a, x, p["ln1_g"], p["ln1_b"], None, 0.0,
                                   False)
        m = self._ffn(p, n, False)
        return dropout_add_layer_norm(m, n, p["ln2_g"], p["ln2_b"], None,
                                      0.0, False)

    def _ids(self, t):
        return torch.as_tensor(t, device=self.tok_emb.device).long()

    @torch.no_grad()
    def prefill(self, tokens, lengths, state):
        """Fill the cache from padded prompts; return last-token logits.

        tokens: (B, Lp) left-aligned prompt ids padded to a shared Lp;
        lengths: (B,) true prompt lengths (the ragged tail is masked with
        a key bias). Returns (logits (B, vocab), state)."""
        self._require_decode_layout()
        tokens = self._ids(tokens)
        lengths = self._ids(lengths).to(torch.int32)
        b, lp = tokens.shape
        dev = tokens.device
        x = self.tok_emb[tokens] + self.pos_emb[None, :lp]
        # additive key bias over the padded tail, (B, 1, 1, Lp): the
        # flash route takes it as a (B, Lp) key bias, exactly like BERT's
        # attention_mask bias
        kb = torch.where(torch.arange(lp, device=dev)[None, :] <
                         lengths[:, None], 0.0, -1e9).to(torch.float32)
        kb = kb[:, None, None, :]
        for i in range(self.n_block):
            def attend(q, k, v, i=i):
                o = flash_attention_blhd(q, k, v, bias=kb, causal=True)
                kv_cache.write_prompt(state.k_cache[i], k)
                kv_cache.write_prompt(state.v_cache[i], v)
                return o
            x = self._decode_block(getattr(self, f"block{i}"), x, attend)
        last = x[torch.arange(b, device=dev),
                 (lengths.long() - 1).clamp_min(0)]
        return self.lm_logits(last), state._replace(lengths=lengths)

    @torch.no_grad()
    def decode_step(self, state, tokens):
        """Advance every slot one token: (B,) ids -> ((B, vocab), state).

        Appends each slot's K/V row at its own write offset and attends
        the single query row against the slab: O(S) per token, no
        full-sequence recompute."""
        self._require_decode_layout()
        pos = state.lengths.clamp(max=self.seq_len - 1).long()
        x = (self.tok_emb[self._ids(tokens)] + self.pos_emb[pos])[:, None]
        for i in range(self.n_block):
            def attend(q, k, v, i=i):
                return kv_cache.cached_attention_step(
                    q, k, v, state.k_cache[i], state.v_cache[i],
                    state.lengths)[0]
            x = self._decode_block(getattr(self, f"block{i}"), x, attend)
        return self.lm_logits(x[:, 0]), \
            state._replace(lengths=state.lengths + 1)

    @torch.no_grad()
    def decode_chunk(self, state, tokens, n_valid=None):
        """Advance every slot C tokens in ONE rectangular attention step:
        (B, C) ids -> ((B, C, vocab), state).

        Chunked prefill feeds prompt slices (``n_valid`` (B,) masks a
        ragged final chunk: lengths advance by n_valid and the tail rows
        land above the watermark, never attended, overwritten by the next
        write). Speculative verification feeds [last, draft_1..draft_k]
        (C = k + 1): row i's logits score draft i+1, and rejected
        suffixes roll back by plain ``lengths`` surgery. Row c embeds at
        position ``lengths + c`` and attends slab keys ``<= lengths + c``
        (``cached_attention_chunk``)."""
        self._require_decode_layout()
        tokens = self._ids(tokens)
        c = tokens.shape[1]
        if n_valid is not None:
            n_valid = self._ids(n_valid).to(torch.int32)
        pos = (state.lengths[:, None] + torch.arange(
            c, device=tokens.device)[None, :]).clamp(max=self.seq_len - 1)
        x = self.tok_emb[tokens] + self.pos_emb[pos]
        for i in range(self.n_block):
            def attend(q, k, v, i=i):
                return kv_cache.cached_attention_chunk(
                    q, k, v, state.k_cache[i], state.v_cache[i],
                    state.lengths, n_valid=n_valid)[0]
            x = self._decode_block(getattr(self, f"block{i}"), x, attend)
        step = c if n_valid is None else n_valid
        return self.lm_logits(x), state._replace(lengths=state.lengths + step)

    def compute_output_shape(self, input_shape):
        first = input_shape[0] if isinstance(input_shape, list) \
            else input_shape
        seq_shape = (first[0], first[1], self.hidden_size)
        pooled = (first[0], self.hidden_size)
        if self.output_all_block:
            return [seq_shape] * self.n_block + [pooled]
        return [seq_shape, pooled]


class BERT(TransformerLayer):
    """BERT encoder (BERT.scala). Inputs: ``[token_ids (B,L),
    position_ids (B,L), segment_ids (B,L), attention_mask (B,1,1,L)]``,
    all as floats."""

    gelu_approximate = False  # BERT.scala overrides gelu with the erf form

    def __init__(self, vocab=40990, hidden_size=768, n_block=12, n_head=12,
                 seq_len=512, intermediate_size=3072, hidden_p_drop=0.1,
                 attn_p_drop=0.1, initializer_range=0.02,
                 output_all_block=True, moe_experts=0, moe_top_k=2,
                 input_shape=None, name=None, **kwargs):
        super().__init__(
            n_block=n_block, hidden_p_drop=hidden_p_drop,
            attn_p_drop=attn_p_drop, n_head=n_head,
            initializer_range=initializer_range, bidirectional=True,
            output_all_block=output_all_block,
            intermediate_size=intermediate_size, vocab=vocab,
            seq_len=seq_len, hidden_size=hidden_size,
            moe_experts=moe_experts, moe_top_k=moe_top_k,
            input_shape=input_shape, name=name)

    def _embedding_params(self, generator):
        params = super()._embedding_params(generator)
        params["seg_emb"] = _normal(generator, (2, self.hidden_size),
                                    self.initializer_range)
        params["emb_ln_g"] = torch.ones(self.hidden_size)
        params["emb_ln_b"] = torch.zeros(self.hidden_size)
        return params

    def _embed(self, inputs):
        tokens, positions, segments, mask = inputs
        e = take_rows(self.tok_emb, tokens)
        e = e + take_rows(self.pos_emb, positions)
        e = e + take_rows(self.seg_emb, segments)
        e = self._ln(e, self.emb_ln_g, self.emb_ln_b, eps=1e-12)
        # extended mask, parity with BERT.scala buildInput:
        # (-mask + 1) * -10000, shape (B, 1, 1, L)
        mask_bias = (1.0 - mask.float()) * -10000.0
        return e, mask_bias

    def compute_output_shape(self, input_shape):
        first = input_shape[0]
        seq_shape = (first[0], first[1], self.hidden_size)
        pooled = (first[0], self.hidden_size)
        if self.output_all_block:
            return [seq_shape] * self.n_block + [pooled]
        return [seq_shape, pooled]
