"""Linear-chain CRF ops: log-likelihood (the forward algorithm) and Viterbi
decoding.

Counterpart of ``analytics_zoo_tpu/ops/crf.py``, whose time recursions are
``lax.scan``s (plain ``jnp``, XLA-compiled); here they are eager loops
over the timesteps. Conventions are the JAX module's: ``unary`` (B, L, E)
per-token emission scores (logits), ``trans`` (E, E) with ``trans[i, j]``
the score of moving from tag i to tag j, ``mask`` (B, L) in {0, 1} with
the real tokens before the padded tail (the first token real). Scores are
float32. Where Viterbi scores tie, the backpointer and the last tag take
the first index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch


def _mask(mask, b, l, device):
    if mask is None:
        return torch.ones((b, l), dtype=torch.float32, device=device)
    return mask.float()


def _first_argmax(x, dim):
    """``argmax`` that takes the first of tied maxima on every backend."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).reshape(shape)
    hit = x == x.amax(dim=dim, keepdim=True)
    return torch.where(hit, idx, n).amin(dim=dim)


def crf_sequence_score(unary, tags, trans, mask=None):
    """Score of a given tag path: the chosen emissions plus transitions."""
    unary = unary.float()
    b, l, e = unary.shape
    tags = tags.long()
    mask = _mask(mask, b, l, unary.device)
    emit = torch.gather(unary, 2, tags[..., None])[..., 0]
    score = (emit * mask).sum(-1)
    if l > 1:
        t = trans[tags[:, :-1], tags[:, 1:]]            # (B, L-1)
        score = score + (t * mask[:, :-1] * mask[:, 1:]).sum(-1)
    return score


def crf_log_normalizer(unary, trans, mask=None):
    """log Z of each sequence by the forward algorithm over time."""
    unary = unary.float()
    b, l, e = unary.shape
    mask = _mask(mask, b, l, unary.device)
    alpha = unary[:, 0]                                 # (B, E)
    for t in range(1, l):
        scores = alpha[:, :, None] + trans[None] + unary[:, t, None, :]
        new = torch.logsumexp(scores, dim=1)
        alpha = torch.where(mask[:, t, None] > 0, new, alpha)
    return torch.logsumexp(alpha, dim=-1)


def crf_log_likelihood(unary, tags, trans, mask=None):
    """log p(tags | unary) of each sequence, the CRF training objective."""
    return crf_sequence_score(unary, tags, trans, mask) - \
        crf_log_normalizer(unary, trans, mask)


def crf_decode(unary, trans, mask=None):
    """Viterbi: (best tags (B, L) int32, best score (B,)). Padded
    positions repeat the last real tag through the identity
    backpointer, as in JAX."""
    unary = unary.float()
    trans = trans.float()
    b, l, e = unary.shape
    mask = _mask(mask, b, l, unary.device)
    alpha = unary[:, 0]
    if l == 1:
        return _first_argmax(alpha, -1).int()[:, None], alpha.amax(-1)
    identity = torch.arange(e, device=unary.device).expand(b, e)
    bps = []
    for t in range(1, l):
        scores = alpha[:, :, None] + trans[None]        # (B, Eprev, Enext)
        bp = _first_argmax(scores, 1)
        new = scores.amax(1) + unary[:, t]
        keep = mask[:, t, None] > 0
        alpha = torch.where(keep, new, alpha)
        bps.append(torch.where(keep, bp, identity))
    last = _first_argmax(alpha, -1)
    best = alpha.amax(-1)
    tags = [last]
    tag = last
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    return torch.stack(tags[::-1], dim=1).int(), best
