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

``moe_experts > 0`` swaps each block's MLP for a :class:`SparseMoE`
(``moe.py``: index dispatch, no dense (N, E, C) tensors) with
``intermediate_size`` and ``moe_top_k``, its parameters under
``block{i}.moe``; attention and both residual sites stay on the same
kernels. The MoE is called without a generator, as the JAX layer calls
it without an rng, so its router noise never acts here. A custom
``embedding_layer`` is a submodule named ``embedding`` (JAX's
``params["embedding"]``): it takes the inputs, its output's last
dimension is the hidden size, and it replaces the token and position
tables.

Data parallelism needs nothing of the layer: the trainer gives each rank
its block of the batch and a generator seeded with its data rank, so the
dropout masks differ across ranks (JAX's ``fold_in(axis_index)``).

Sequence parallelism (``ZooConfig.sequence_parallel`` = sp > 1, JAX
:281-345): each seq rank holds only its L/sp chunk of every block's
activations. It embeds its chunk of the inputs (the position table at the
chunk's offset), draws its dropout from the step's generator folded with
its seq rank, and runs attention over the seq group: Ulysses
(``parallel/ulysses.py``: two all-to-alls around the flash kernels on
H/sp heads) or the ring (``parallel/ring_attention.py``, plain torch), as
``sequence_parallel_mode`` says (auto: Ulysses when the heads divide by
sp); the key bias rides along. At the layer's exit each returned
sequence output is all-gathered over the seq group into the global
(B, L, h) tensor, as JAX's sharded attention returns it (the backward
reduce-scatters), and the pooler reads its first token. Every seq rank
computes the same loss, so the trainer divides the gradients it sums over
the seq group by sp. A length that does not split over sp runs unsplit on every
seq rank, as JAX's layer then runs unsharded attention.

Tensor parallelism (``model_parallel`` = tp > 1, the Megatron layout of
JAX's rules, :204-220): the layer's parameters carry the logical axes
JAX annotates, and under the trainer's layout (``parallel/sharding.py``)
each model rank holds its columns of qkv and MLP-in and its rows of proj
and MLP-out. The layer reads the layout from the shapes it is given:
with ``qkv_w`` narrower than 3h it computes on its H/tp heads (K1-K3 at
(B, L, H/tp, d)), with ``mlp_in_w`` narrower than the intermediate size
on its columns, each region entered through ``copy_to_region`` and left
through ``reduce_from_region`` over the model group before the replicated
bias; the residual sites (K4/K5) run on the replicated full hidden. JAX's
``qkv_w`` is (h, 3h) with q, k and v side by side, and a contiguous block
of its columns is not a rank's heads, so the layer declares the leaf
three parts (``param_pieces``): a rank's block is its heads' columns of
each of q, k and v. The attention-output dropout draws the whole
(B, L, h) mask and keeps the rank's columns, so every rank's generator
stays in step and the masks are the unsharded layer's.

Pipeline parallelism (``pipeline_parallel`` = S > 1, JAX :237-260 and
:424-490): built under a pipe axis, the layer stacks its blocks'
parameters on a leading 'stage' axis (``blocks.qkv_w`` (n_block, h, 3h),
...), refusing an ``n_block`` S does not divide and ``output_all_block``;
each pipe rank holds its n_block/S blocks. The trunk runs through
``parallel.pipeline.pipeline_forward``: the embedding output and the
attention mask travel together between stages, microbatch ``m`` at B/M
rows, ``M`` = ``pipeline_microbatches`` (0: one per stage). Dropout in
the trunk follows the port's own rule: block ``i`` of microbatch ``m``
draws from a generator seeded from (the step generator's seed, m, i),
host integers every pipe rank derives alike, so nothing crosses the
wire for them (JAX folds one seed with the pipe index and reuses it
for every microbatch). KV-cache decoding refuses the stacked layout and
a cut parameter, as JAX's refuses the stacked one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .....ops import kv_cache
from .....ops.attention import flash_attention_blhd
from .....ops.fused_dropout_ln import dropout_add_layer_norm
from .....ops.layernorm import layer_norm
from .....parallel.collectives import copy_to_region, reduce_from_region
from .....parallel.mesh import ambient_axis
from ..engine.base import KerasLayer
from .embeddings import take_rows


class _SeqSplit(NamedTuple):
    """This rank's part of a sequence split over the seq group."""

    group: object
    n: int
    rank: int
    chunk_len: int

    def chunk(self, t, dim: int = 1):
        return t.narrow(dim, self.rank * self.chunk_len, self.chunk_len)


def _seq_split(length: int) -> Optional[_SeqSplit]:
    """The seq group's split of a sequence of ``length`` (None without a
    seq axis, or when the length does not split over it)."""
    from .....common import nncontext as _nn
    ctx = _nn._global_context
    mesh = getattr(ctx, "mesh", None)
    if mesh is None or mesh.shape["seq"] <= 1 or \
            length % mesh.shape["seq"]:
        return None
    n = mesh.shape["seq"]
    return _SeqSplit(mesh.group("seq"), n, mesh.index("seq"), length // n)


def _seq_mode() -> str:
    from .....common import nncontext as _nn
    mode = str(getattr(_nn._global_context.config, "sequence_parallel_mode",
                       "auto")).lower()
    if mode not in ("auto", "ring", "ulysses"):
        raise ValueError(f"sequence_parallel_mode must be auto|ring|"
                         f"ulysses, got {mode!r}")
    return mode


def _normal(generator, shape, std):
    return std * torch.randn(shape, generator=generator)


def _dropout(x, p, generator, training, cols=None):
    """Inverted dropout with a Bernoulli keep-mask drawn from
    ``generator`` (the embedding and attention-output sites). ``cols``
    ``(start, width, whole)``: ``x`` holds columns ``start:start+width``
    of a ``whole``-wide last dimension; the whole mask is drawn and its
    columns kept."""
    if not training or generator is None or p <= 0.0:
        return x
    keep = 1.0 - p
    shape = x.shape if cols is None else x.shape[:-1] + (cols[2],)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if cols is not None:
        mask = mask[..., cols[0]:cols[0] + cols[1]]
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def _parallel_degree(field: str) -> int:
    """A parallel degree from the ambient context's config (1 without a
    context). Peeks the global context without creating one."""
    from .....common import nncontext as _nn
    ctx = _nn._global_context
    if ctx is None:
        return 1
    return int(getattr(ctx.config, field, 1))


def _stack(per_block):
    """Per-block parameter dicts stacked leaf by leaf on a new leading
    axis (nested dicts, a MoE block's, stack inside)."""
    first = per_block[0]
    return {k: _stack([p[k] for p in per_block]) if isinstance(v, dict)
            else torch.stack([p[k] for p in per_block])
            for k, v in first.items()}


def _flat_params(tree, prefix=""):
    """A ParameterDict tree as {dotted path: tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, torch.nn.ParameterDict)):
            out.update(_flat_params(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    """{dotted path: tensor} as nested dicts."""
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


class TransformerLayer(KerasLayer):
    """GPT-style transformer stack.

    Inputs: token ids ``(B, L)`` as floats (positions are implicit
    arange). Outputs ``(sequence_states, pooled)`` (or all block states +
    pooled when ``output_all_block``)."""

    stochastic = True
    gelu_approximate = True  # TransformerLayer.scala uses the tanh approx
    # the Megatron layout: heads and MLP columns over model, the stacked
    # blocks over pipe, a MoE block's experts over expert
    sharded_compute = {"heads": "model", "mlp": "model", "stage": "pipe",
                       "expert": "expert"}

    def __init__(self, n_block, hidden_p_drop=0.1, attn_p_drop=0.1,
                 n_head=12, initializer_range=0.02, bidirectional=False,
                 output_all_block=False, intermediate_size=0,
                 vocab=40990, seq_len=77, hidden_size=768,
                 embedding_layer=None, moe_experts=0, moe_top_k=2,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name)
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
        self.moe_experts = int(moe_experts)
        self.moe_top_k = int(moe_top_k)
        # the MoE's parameters live under each block; the layer object is
        # kept off the module tree (it holds no parameters of its own)
        object.__setattr__(self, "_moe", None)
        if embedding_layer is not None:
            self.add_module("embedding", embedding_layer)
            out_shape = embedding_layer.compute_output_shape(
                (None, self.seq_len))
            self.hidden_size = int(out_shape[-1])
        self.intermediate_size = int(intermediate_size) or \
            4 * self.hidden_size
        if self.hidden_size % self.n_head:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of n_head {self.n_head}")
        self.num_outputs = (self.n_block if output_all_block else 1) + 1

    @property
    def embedding_layer(self):
        return self._modules.get("embedding")

    # -- params --------------------------------------------------------
    def _embedding_params(self, generator):
        if self.embedding_layer is not None:
            if not self.embedding_layer.built:
                self.embedding_layer.build_params(generator,
                                                  (None, self.seq_len))
            return {}
        params = {
            "tok_emb": _normal(generator, (self.vocab, self.hidden_size),
                               self.initializer_range),
            "pos_emb": _normal(generator, (self.seq_len, self.hidden_size),
                               self.initializer_range),
        }
        self._annotate(tok_emb=("vocab", "embed"), pos_emb=(None, "embed"))
        return params

    def _block_params(self, generator):
        h = self.hidden_size
        m = self.intermediate_size
        std = self.initializer_range
        p = {
            "qkv_w": _normal(generator, (h, 3 * h), std),
            "qkv_b": torch.zeros(3 * h),
            "proj_w": _normal(generator, (h, h), std),
            "proj_b": torch.zeros(h),
            "ln1_g": torch.ones(h), "ln1_b": torch.zeros(h),
            "ln2_g": torch.ones(h), "ln2_b": torch.zeros(h),
        }
        if self.moe_experts:
            p["moe"] = self._moe.build(generator, (None, self.seq_len, h))
        else:
            p.update({
                "mlp_in_w": _normal(generator, (h, m), std),
                "mlp_in_b": torch.zeros(m),
                "mlp_out_w": _normal(generator, (m, h), std),
                "mlp_out_b": torch.zeros(h),
            })
        return p

    def _block_axis_map(self):
        """Logical axes per block parameter (the Megatron TP layout)."""
        axes = {
            "qkv_w": ("embed", "heads"), "qkv_b": ("heads",),
            "proj_w": ("heads", "embed"), "proj_b": (None,),
            "ln1_g": (None,), "ln1_b": (None,),
            "ln2_g": (None,), "ln2_b": (None,),
        }
        if self.moe_experts:
            for k, v in self._moe.param_axes().items():
                axes[f"moe/{k}"] = v
        else:
            axes.update({"mlp_in_w": ("embed", "mlp"),
                         "mlp_in_b": ("mlp",),
                         "mlp_out_w": ("mlp", "embed"),
                         "mlp_out_b": (None,)})
        return axes

    def param_pieces(self):
        """q, k and v side by side in the last dimension of ``qkv_w`` and
        ``qkv_b`` (per block, or stacked): three parts, cut part by
        part."""
        return {k: (len(v) - 1, 3) for k, v in self.param_axes().items()
                if k.rsplit("/", 1)[-1] in ("qkv_w", "qkv_b")}

    def build(self, generator, input_shape):
        if self.moe_experts and self._moe is None:
            from .moe import SparseMoE
            object.__setattr__(self, "_moe", SparseMoE(
                self.moe_experts, self.intermediate_size,
                top_k=self.moe_top_k))
        params = self._embedding_params(generator)
        pp = _parallel_degree("pipeline_parallel")
        if pp > 1:
            # the GPipe layout: block parameters stacked on a leading
            # 'stage' axis, so each pipe rank holds only its blocks
            if self.n_block % pp:
                raise ValueError(
                    f"pipeline_parallel={pp} must divide n_block="
                    f"{self.n_block}")
            if self.output_all_block:
                raise ValueError(
                    "output_all_block=True is incompatible with "
                    "pipeline_parallel > 1 (intermediate block states "
                    "live on other pipe ranks); build with "
                    "output_all_block=False")
            per_block = [self._block_params(generator)
                         for _ in range(self.n_block)]
            params["blocks"] = _stack(per_block)
            self._annotate(**{
                f"blocks/{k}": ("stage",) + tuple(v)
                for k, v in self._block_axis_map().items()})
        else:
            for i in range(self.n_block):
                params[f"block{i}"] = self._block_params(generator)
                self._annotate(**{
                    f"block{i}/{k}": v
                    for k, v in self._block_axis_map().items()})
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

    def _model_group(self, width: int, whole: int):
        """The model group and this rank's index where a weight of
        ``width`` columns is this rank's block of ``whole`` (tensor
        parallelism), else (None, 0)."""
        if width == whole:
            return None, 0
        group, n, r = ambient_axis("model")
        if n * width != whole:
            raise ValueError(f"a block of {width} of {whole} columns does "
                             f"not match the model axis ({n} ranks)")
        return group, r

    def _attention(self, p, x, mask_bias, generator, training, seq=None):
        b, l, h = x.shape
        d = h // self.n_head
        # this rank's columns of each of q, k and v: all of them, or its
        # heads' under tensor parallelism
        width = p["qkv_w"].shape[-1] // 3
        if width % d:
            raise ValueError(f"{width} columns of q are not whole heads of "
                             f"{d}: n_head={self.n_head} must divide over "
                             f"the model axis")
        nh = width // d
        tp, tp_rank = self._model_group(width, h)
        xin = copy_to_region(x, tp)
        qkv = torch.matmul(xin, p["qkv_w"].to(x.dtype)) + \
            p["qkv_b"].to(x.dtype)
        q, k, v = qkv.split(width, dim=-1)
        # (B, L, H, d) views of the fused projection feed the kernel
        # directly: no [B, H, L, d] relayout copies in, none out
        q4, k4, v4 = (t.reshape(b, l, nh, d) for t in (q, k, v))
        if seq is None:
            o = flash_attention_blhd(q4, k4, v4, bias=mask_bias,
                                     causal=not self.bidirectional)
        else:
            from .....parallel.ring_attention import ring_attention_blhd
            from .....parallel.ulysses import ulysses_attention_blhd

            mode = _seq_mode()
            attend = ulysses_attention_blhd if mode == "ulysses" or (
                mode == "auto" and nh % seq.n == 0) else ring_attention_blhd
            kb = None if mask_bias is None else mask_bias.reshape(
                mask_bias.shape[0], l).float().expand(b, l)
            o = attend(q4, k4, v4, seq.group,
                       causal=not self.bidirectional, kbias=kb)
        o = o.reshape(b, l, width)
        o = _dropout(o, self.attn_p_drop, generator, training,
                     None if tp is None else (tp_rank * width, width, h))
        a = reduce_from_region(torch.matmul(o, p["proj_w"].to(x.dtype)), tp)
        return a + p["proj_b"].to(x.dtype)

    def _block(self, p, x, mask_bias, generator, training, seq=None):
        a = self._attention(p, x, mask_bias, generator, training, seq)
        n = dropout_add_layer_norm(a, x, p["ln1_g"], p["ln1_b"], generator,
                                   self.hidden_p_drop, training)
        m = self._ffn(p, n, training)
        return dropout_add_layer_norm(m, n, p["ln2_g"], p["ln2_b"],
                                      generator, self.hidden_p_drop,
                                      training)

    def _ffn(self, p, n, training):
        if self.moe_experts:
            return self._moe.dispatch(p["moe"], n, training=training)
        tp, _ = self._model_group(p["mlp_in_w"].shape[-1],
                                  self.intermediate_size)
        m = torch.matmul(copy_to_region(n, tp), p["mlp_in_w"].to(n.dtype)) \
            + p["mlp_in_b"].to(n.dtype)
        m = self._gelu(m)
        m = reduce_from_region(torch.matmul(m, p["mlp_out_w"].to(n.dtype)),
                               tp)
        return m + p["mlp_out_b"].to(n.dtype)

    def _embed(self, inputs, training=False, seq=None):
        if self.embedding_layer is not None:
            x = inputs if not isinstance(inputs, (list, tuple)) or \
                len(inputs) > 1 else inputs[0]
            e = self.embedding_layer(x, training=training)
            return (e if seq is None else seq.chunk(e)), None
        tokens = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        offset = 0
        if seq is not None:
            tokens = seq.chunk(tokens)
            offset = seq.rank * seq.chunk_len
        e = take_rows(self.tok_emb, tokens)
        e = e + self.pos_emb[None, offset:offset + e.shape[1]]
        return e, None

    def _pooler(self, x):
        return torch.tanh(torch.matmul(x[:, 0], self.pooler_w.to(x.dtype)) +
                          self.pooler_b.to(x.dtype))

    @staticmethod
    def _inputs_length(inputs) -> int:
        first = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        return int(first.shape[1])

    def forward(self, inputs, training=False, generator=None, **kw):
        seq = _seq_split(self._inputs_length(inputs))
        if seq is not None and generator is not None:
            # each seq rank draws the masks of its own chunk
            from ....engine import step_seed
            folded = torch.Generator(device=generator.device)
            folded.manual_seed(step_seed(generator.initial_seed(), seq.rank))
            generator = folded
        e, mask_bias = self._embed(inputs, training, seq)
        e = _dropout(e, self.hidden_p_drop, generator, training)
        if "blocks" in self._modules:   # the GPipe layout
            if seq is not None:
                raise ValueError("the pipelined trunk does not run beside "
                                 "sequence parallelism")
            x = self._call_pp(e, mask_bias, generator, training)
            return (x, self._pooler(x))
        states = []
        x = e
        for i in range(self.n_block):
            x = self._block(getattr(self, f"block{i}"), x, mask_bias,
                            generator, training, seq)
            states.append(x)
        if seq is not None:
            # the sequence outputs are global (B, L, h) tensors, as JAX's
            # sharded attention returns them: each seq rank's chunk is
            # all-gathered in rank order (the backward reduce-scatters)
            from .....parallel.collectives import all_gather
            keep = states if self.output_all_block else states[-1:]
            states = [all_gather(t, seq.group, dim=1) for t in keep]
            x = states[-1]
        pooled = self._pooler(x)
        if self.output_all_block:
            return tuple(states) + (pooled,)
        return (x, pooled)

    def _call_pp(self, e, mask_bias, generator, training):
        """The block trunk as a GPipe pipeline over the pipe group
        (``parallel/pipeline.py``): this rank's stacked blocks, the
        activations and the attention mask travelling together."""
        from .....common.nncontext import get_nncontext
        from .....parallel.pipeline import pipeline_forward
        from ....engine import step_seed

        ctx = get_nncontext()
        group, S, stage = ambient_axis("pipe")
        blocks = _flat_params(self.blocks)
        bps = next(iter(blocks.values())).shape[0]
        if bps * S != self.n_block:
            raise ValueError(f"{bps} stacked blocks on each of {S} pipe "
                             f"ranks do not make n_block={self.n_block}")
        n_micro = int(getattr(ctx.config, "pipeline_microbatches", 0)) or S
        b = e.shape[0]
        tree = {"x": e}
        if mask_bias is not None:
            tree["mask"] = mask_bias.expand((b,) + tuple(mask_bias.shape[1:]))
        seed = None if generator is None or not training else \
            generator.initial_seed()

        def run_stage(p, t, m):
            x, mask = t["x"], t.get("mask")
            for i in range(bps):
                gen = None
                if seed is not None:
                    gen = torch.Generator(device=x.device)
                    gen.manual_seed(step_seed(step_seed(seed, m),
                                              stage * bps + i))
                x = self._block(_nest({k: v[i] for k, v in p.items()}), x,
                                mask, gen, training)
            return dict(t, x=x)

        return pipeline_forward(run_stage, blocks, tree, group=group,
                                n_microbatch=n_micro, pass_micro=True)["x"]

    # -- KV-cache incremental decode (ops/kv_cache.py) -----------------
    #
    # The generative-serving path: prefill runs the prompt once through
    # the causal flash route and stashes every block's projected K/V into
    # preallocated slabs; decode_step then advances one token per call
    # with O(S) cached attention. Decode is inference-only: no dropout,
    # no autograd, and the per-block layout of whole parameters.

    def _require_decode_layout(self):
        if self.bidirectional:
            raise ValueError(
                "KV-cache decode needs a causal trunk; this layer was "
                "built bidirectional (BERT-style)")
        if "blocks" in self._modules:
            raise ValueError(
                "KV-cache decode does not support the pipeline-parallel "
                "stacked-block layout; rebuild with pipeline_parallel=1")
        if any(hasattr(p, "_zoo_shard") for p in self.parameters()):
            raise ValueError("KV-cache decode needs the layer's parameters "
                             "whole; this layer is laid out over ranks")

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

    def _embed(self, inputs, training=False, seq=None):
        tokens, positions, segments, mask = inputs
        if seq is not None:
            tokens, positions, segments = (seq.chunk(t) for t in
                                           (tokens, positions, segments))
            mask = seq.chunk(mask, dim=3)
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
