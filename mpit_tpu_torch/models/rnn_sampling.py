"""Autoregressive decoding for :class:`~mpit_tpu_torch.models.lstm.LSTMLM`;
counterpart of ``mpit_tpu/models/rnn_sampling.py``.

The transformer's serving recipe with the carry in place of the K/V cache:
the prompt enters in one pass (each row's carries freeze at its own
length through ``seq_lengths``), then every generated token is a one-step
carry update. Buckets, key streams, filters, validation, eos truncation
and ``weights_dtype`` are :mod:`~mpit_tpu_torch.models.sampling`'s; there
is no ``max_len``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpit_tpu_torch import random as jrandom
from mpit_tpu_torch.models import sampling


def _rnn_prefill(model, params, cache0, pre_buf, p_lens, with_head=True):
    """The one RNN padded-prefill recipe (the batch loop and the
    RNNServer's admission and prefix template): the prompt buffer through
    one pass with ``seq_lengths`` freezing each row's carries at its own
    length, then the head on each row's last true position. Returns
    ``(cache, last_logits)``, or ``(cache, None)`` with ``with_head=False``."""
    hidden, cache = model.clone(head=False).apply(params, pre_buf, cache0,
                                                  seq_lengths=p_lens)
    if not with_head:
        return cache, None
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return cache, model.head_logits(params, hidden[rows, p_lens.long() - 1])


def _rnn_prefill_decode_scan(model, steps, greedy, top_k, use_top_p,
                             use_min_p, params, cache0, pre_buf, p_lens, keys,
                             temp, top_p, min_p):
    """The prompt pass, token 0 from its head, then ``steps - 1`` ticks;
    the (N, steps) tokens on the device."""
    cache, last = _rnn_prefill(model, params, cache0, pre_buf, p_lens)
    mp = min_p if use_min_p else None
    prev = sampling._sample_rows(last, keys[:, 0], greedy, top_k, use_top_p,
                                 temp, top_p, mp)
    out = torch.empty(prev.shape[0], steps, dtype=torch.long, device=prev.device)
    out[:, 0] = prev
    for t in range(steps - 1):
        logits, cache = model.apply(params, prev[:, None], cache)
        prev = sampling._sample_rows(logits[:, 0], keys[:, t + 1], greedy,
                                     top_k, use_top_p, temp, top_p, mp)
        out[:, t + 1] = prev
    return out


@torch.no_grad()
def generate_rnn(
    model,
    params,
    prompts,
    steps: int,
    temperature: float = 0.0,
    seed: int = 0,
    rng=None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    weights_dtype=None,
    eos_id: Optional[int] = None,
    min_p: Optional[float] = None,
    device=None,
):
    """Continue prompt(s) by ``steps`` tokens with a carry-decode LSTM.

    ``prompts`` is one prompt (a flat sequence of ints; returns one token
    list) or a list of prompts (returns a list of rows, row ``n`` equal to
    its solo call at ``fold_in(rng, n)``). The empty list is one empty
    prompt and is refused; the empty tuple ``()`` is the empty batch and
    returns ``[]``, as in the reference."""
    if isinstance(prompts, tuple) and len(prompts) == 0:
        return []
    solo = len(prompts) == 0 or not hasattr(prompts[0], "__len__")
    batch = [prompts] if solo else list(prompts)
    for q in batch:
        sampling._validate(model, q, temperature, top_k, top_p, eos_id, min_p)
    if steps <= 0:
        rows = [[int(t) for t in q] for q in batch]
        return rows[0] if solo else rows
    params, dev = sampling._on(params, device)
    if weights_dtype is not None:
        params = sampling.cast_weights(params, weights_dtype)
    key = sampling._keys(rng, seed, dev)
    if solo:
        rngs = key[None]
    else:
        rngs = jrandom.fold_in(key[None].expand(len(batch), 2),
                               torch.arange(len(batch), device=dev))
    n = len(batch)
    nb, _, _, pre_buf, p_lens, keys = sampling._prep_rows(batch, steps, rngs, 1 << 30)
    dec = model.clone(decode=True)
    gen = _rnn_prefill_decode_scan(
        dec, steps, temperature == 0.0, top_k,
        top_p is not None, min_p is not None,
        params, dec.init_cache(nb, dev), pre_buf, p_lens, keys,
        np.float32(max(temperature, 1e-9)),
        np.float32(1.0 if top_p is None else top_p),
        np.float32(0.0 if min_p is None else min_p),
    )
    host = gen.cpu().tolist()
    rows = [
        sampling._truncate_at_eos(
            [int(t) for t in batch[i]] + host[i], len(batch[i]), eos_id,
        )
        for i in range(n)
    ]
    return rows[0] if solo else rows
