"""Synthetic token pipeline for LM training (PyTorch port of
``repro.data.tokens``), the JAX package's streams bit for bit.

Token streams come from ONE fixed first-order Markov chain over the
vocabulary (per corpus seed): a model that learns the bigram statistics
gets a real loss reduction, so training curves mean something without a
downloaded corpus.

JAX samples a stream with ``lax.scan`` over its step keys and a batch
with ``vmap``.  The port draws a batch's streams together: one ``split``
gives every stream all its step keys, one Gumbel draw all their noise
(``rng.categorical``'s, from the same keys), and each step is one argmax
over the batch.  No Python loop runs over the batch.
"""
from __future__ import annotations

from typing import Iterator

import torch

from repro_torch import rng


def markov_chain(seed: int, vocab: int, top: int = 64, device=None):
    """The corpus's fixed transition structure: ([vocab, top] int32
    successor ids, [vocab, top] float32 logits)."""
    k1, k2 = rng.split(rng.PRNGKey(seed, device=device)).unbind(0)
    succ = rng.randint(k1, (vocab, top), 0, vocab)
    logits = rng.normal(k2, (vocab, top)) * 2.0
    return succ, logits


def sample_stream(key: torch.Tensor, succ: torch.Tensor,
                  logits: torch.Tensor, length: int) -> torch.Tensor:
    """[..., length] int32 streams from the SHARED chain, one a key of
    ``key`` [..., 2] (JAX's ``sample_stream``, and its ``vmap`` over
    batched keys): a first token drawn uniformly, then each next token a
    categorical draw over the current token's successors."""
    lead = tuple(key.shape[:-1])
    keys = key.reshape(-1, 2)
    ks, k0 = rng.split(keys).unbind(-2)
    vocab, top = succ.shape
    tok = rng.randint(k0, (), 0, vocab).long()                   # [K]
    steps = rng.split(ks, length)                                # [K, L, 2]
    noise = rng.gumbel(steps, (top,))                            # [K, L, top]
    out = torch.empty((keys.shape[0], length), dtype=torch.int32,
                      device=keys.device)
    for t in range(length):
        idx = torch.argmax(noise[:, t] + logits[tok], dim=-1)
        tok = succ[tok, idx].long()
        out[:, t] = tok
    return out.reshape(lead + (length,))


def token_batches(seed: int, vocab: int, batch: int, seq_len: int,
                  n_batches: int, top: int = 64,
                  device=None) -> Iterator[dict]:
    """Yields {"tokens": [B, T + 1] int32} so callers can shift for inputs
    and labels; on ``device`` (default the CPU)."""
    succ, logits = markov_chain(seed, vocab, top, device)
    key = rng.PRNGKey(seed + 1, device=device)
    for i in range(n_batches):
        kb = rng.fold_in(key, i)
        yield {"tokens": sample_stream(rng.split(kb, batch), succ, logits,
                                       seq_len + 1)}
