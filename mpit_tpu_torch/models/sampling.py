"""Autoregressive decoding for :class:`TransformerLM`; counterpart of
``mpit_tpu/models/sampling.py`` (all of it but ``generate_tp``, which waits
for tensor parallelism, ROADMAP.md item A11).

Two recipes with the same sampling semantics:

- :func:`generate` — the fixed-buffer recipe: every step runs the model as
  the caller built it (a ``flash`` model launches its forward kernel once
  per layer per token) on a ``(1, max_len)`` buffer and reads the logits at
  the current position; the only recipe that slides past ``max_len``.
- :func:`generate_fast` (and :func:`generate_batch`, :func:`beam_search`)
  — the serving recipe: a decode-mode clone with an explicit K/V cache
  tree; each row's whole prompt enters the cache as one ``head=False``
  chunk (:func:`_prefill_chunk`), then every generated token is one tick.

What the reference compiles, the port runs eagerly, but the decisions that
shape the results are the reference's: the power-of-two buckets of the
prompt and row counts (:func:`_bucket`, :func:`_prep_rows`) decide the
pad rows, the prefill chunk's length and which cache slots hold garbage;
token ``j`` of a row is drawn with key ``j`` of the row's stream
(``split(rng, steps)``, row ``n`` of a batch at ``fold_in(rng, n)``,
:mod:`mpit_tpu_torch.random`); and the filters are the reference's down to
their tie order. The reference pads the generation to a power of two as
well and discards the extra ticks' samples; here exactly ``steps`` tokens
are drawn. A row's tokens stay on the device until the call returns: one
host fetch per call, none per tick.

Every entry point runs on the card unless ``device="cpu"`` is passed; the
params are moved there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mpit_tpu_torch import random as jrandom
from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import ROW_BLOCK
from mpit_tpu_torch.utils.params import tree_map


def _on(params, device):
    """``params`` on the entry point's device (the card unless ``device``
    names the CPU), and that device."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params), dev


def _keys(rng, seed: int, dev) -> torch.Tensor:
    """The caller's key (``random.key`` data, (2,)) or ``key(seed)``."""
    return jrandom.key(seed, dev) if rng is None else torch.as_tensor(rng).to(dev)


@torch.no_grad()
def generate(
    model,
    params,
    prompt: Sequence[int],
    steps: int,
    temperature: float = 0.0,
    seed: int = 0,
    rng=None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
    device=None,
) -> list:
    """Continue ``prompt`` by ``steps`` tokens; returns prompt + new.

    ``temperature=0``: greedy argmax. ``>0``: softmax sampling at that
    temperature with key ``i`` of ``split(rng or key(seed), steps)`` for
    token ``i``, filtered top-k → min-p → top-p (:func:`_filter_logits`).
    The model runs as built (training mode, any ``attn_impl``) on a fixed
    ``(1, max_len)`` buffer; past ``max_len`` the window slides."""
    _validate(model, prompt, temperature, top_k, top_p, min_p=min_p)
    params, dev = _on(params, device)
    length = model.max_len
    buf = torch.zeros(1, length, dtype=torch.long, device=dev)
    buf[0, : len(prompt)] = torch.tensor([int(t) for t in prompt], device=dev)
    pos = len(prompt)
    keys = jrandom.split(_keys(rng, seed, dev), max(steps, 1))
    toks = [int(t) for t in prompt]
    for i in range(steps):
        if pos >= length:  # slide the window (positions shift)
            buf = torch.roll(buf, -1, dims=1)
            pos = length - 1
        logits = model.apply(params, buf)[0, pos - 1]
        if temperature > 0:
            scaled = _filter_logits(
                (logits / np.float32(temperature))[None], top_k,
                None if top_p is None else _col(top_p, 1, dev),
                None if min_p is None else _col(min_p, 1, dev))
            nxt = jrandom.categorical(keys[i][None], scaled)[0]
        else:
            nxt = torch.argmax(logits)
        buf[0, pos] = nxt
        toks.append(int(nxt))
        pos += 1
    return toks


def _validate(
    model, prompt, temperature, top_k=None, top_p=None, eos_id=None,
    min_p=None,
):
    """Shared argument checks for every decoding entry point (the
    reference's, message for message)."""
    if eos_id is not None and not 0 <= eos_id < model.vocab_size:
        raise ValueError(
            f"eos_id={eos_id} outside [0, vocab_size={model.vocab_size})"
        )
    if getattr(model, "seq_axis", None) is not None:
        raise ValueError(
            "generation runs the dense model; clone(seq_axis=None) first"
        )
    max_len = getattr(model, "max_len", None)  # RNN LMs have no cap
    if len(prompt) < 1 or (max_len is not None and len(prompt) > max_len):
        raise ValueError(
            f"prompt of {len(prompt)} tokens must be in [1, "
            f"max_len={max_len}]"
        )
    if temperature < 0:
        raise ValueError(f"temperature={temperature} must be >= 0")
    if top_k is not None and not 1 <= top_k <= model.vocab_size:
        raise ValueError(
            f"top_k={top_k} must be in [1, vocab_size={model.vocab_size}]"
        )
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} must be in (0, 1]")
    if min_p is not None and not 0.0 < min_p <= 1.0:
        raise ValueError(f"min_p={min_p} must be in (0, 1]")
    if (
        (top_k is not None or top_p is not None or min_p is not None)
        and temperature == 0
    ):
        raise ValueError(
            "top_k/top_p/min_p shape the SAMPLING distribution; "
            "temperature=0 is greedy argmax, which they cannot affect — "
            "set temperature > 0"
        )
    bad = [t for t in prompt if not 0 <= int(t) < model.vocab_size]
    if bad:
        raise ValueError(
            f"prompt tokens {bad} outside [0, vocab_size="
            f"{model.vocab_size}) — the embedding lookup would read out of "
            "range"
        )


def _col(value, n: int, dev) -> torch.Tensor:
    """A scalar or per-row value as an (n, 1) float32 column."""
    return torch.as_tensor(value, dtype=torch.float32, device=dev).reshape(-1, 1).expand(n, 1)


def _filter_logits(logits, top_k, top_p=None, min_p=None):
    """Mask each row of ``logits`` (N, V) outside the top-k set / the min-p
    band / the top-p nucleus to -inf, in that order (the reference's
    ``_filter_logits``, vmapped). ``top_p``/``min_p`` are (N, 1) columns.

    top-k keeps every token equal to the k-th value; min-p keeps tokens
    with ``l >= max + log(min_p)``; top-p sorts the row descending as the
    reference does (a stable ascending sort, reversed: among equal logits
    the higher index comes first) and keeps the tokens whose mass before
    them is below ``top_p``."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if min_p is not None:
        # log in float64: PyTorch's float32 CPU log now and then misses by 4e-5
        floor = logits.amax(-1, keepdim=True) + torch.log(min_p.double()).float()
        logits = torch.where(logits < floor, float("-inf"), logits)
    if top_p is not None:
        order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
        probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
        before = torch.cumsum(probs, -1) - probs
        keep = torch.empty_like(before, dtype=torch.bool)
        keep.scatter_(-1, order, before < top_p)
        logits = torch.where(keep, logits, float("-inf"))
    return logits


def _filter_blocks(logits, top_k, top_p=None, min_p=None):
    """:func:`_filter_logits` over ``ROW_BLOCK`` rows at a time, a short
    block filled up with copies of its first row: its sort, softmax and
    running sum then see a row count that the batch does not set, as the
    decode path's products do (``models/transformer.py``)."""
    n = logits.shape[0]
    out = []
    for s in range(0, n, ROW_BLOCK):
        rows = slice(s, min(s + ROW_BLOCK, n))

        def block(a):
            if a is None:
                return None
            a = a[rows]
            short = ROW_BLOCK - a.shape[0]
            return torch.cat([a, a[:1].expand(short, *a.shape[1:])]) if short else a

        kept = _filter_logits(block(logits), top_k, block(top_p), block(min_p))
        out.append(kept[: rows.stop - s])
    return out[0] if len(out) == 1 else torch.cat(out)


@torch.no_grad()
def generate_fast(
    model,
    params,
    prompt: Sequence[int],
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
) -> list:
    """KV-cached generation: continue ``prompt`` by ``steps`` tokens, the
    same sampling semantics as :func:`generate` (the one-row case of
    :func:`generate_batch`). ``len(prompt) + steps`` must fit in
    ``max_len``; the cached attention is the plain one whatever
    ``attn_impl`` the model was built with. Truncated just past the first
    ``eos_id`` after the prompt."""
    _validate(model, prompt, temperature, top_k, top_p, eos_id, min_p)
    if steps <= 0:
        return [int(t) for t in prompt]
    params, dev = _on(params, device)
    if weights_dtype is not None:
        params = cast_weights(params, weights_dtype)
    return _truncate_at_eos(
        _generate_rows(
            model, params, [prompt], steps, temperature,
            _keys(rng, seed, dev)[None], top_k, top_p, min_p=min_p,
        )[0],
        len(prompt), eos_id,
    )


def _bucket(n, cap):
    """The one power-of-two bucket rule of every decode dimension: the
    smallest power of two >= n, capped at ``cap``."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _decode_setup(model, prompt, steps):
    """The overflow contract and the decode-mode clone."""
    total = len(prompt) + steps
    if total > model.max_len:
        raise ValueError(
            f"prompt+steps = {total} exceeds max_len={model.max_len}; "
            "the KV cache cannot slide — use generate() for overflow"
        )
    return model.clone(decode=True)


def _beam_scan(model, steps, beam, eos_id, params, cache1, pre_buf, p_len):
    """Fixed-budget beam search with chunked prefill (the reference's
    ``_beam_scan``): the prompt prefills once at batch 1, the cache is
    repeated across the beams, expansion 0 scores the prefill logits with
    beam 0 alone live, and every later expansion ticks all beams and
    reorders the caches by parent. Candidates are ranked by a stable
    descending sort of the flattened (beam·vocab) scores, which puts the
    lower index first among equals as ``lax.top_k`` does. (The reference
    runs up to a power of two of expansions, frozen past ``steps``; frozen
    ones change nothing, so only ``steps`` run here.)

    Returns ``(gen_tokens (beam, steps), scores (beam,))``."""
    vocab = model.vocab_size
    dev = pre_buf.device

    def expand(logp, scores, done):
        cand = scores[:, None] + logp
        if eos_id is not None:
            pad_row = torch.full((vocab,), float("-inf"), device=dev)
            pad_row[eos_id] = 0.0
            cand = torch.where(done[:, None], scores[:, None] + pad_row[None, :], cand)
        top_scores, top_idx = torch.sort(cand.reshape(-1), descending=True, stable=True)
        top_scores, top_idx = top_scores[:beam], top_idx[:beam]
        return top_scores, top_idx // vocab, top_idx % vocab

    hidden, cache = model.clone(head=False).apply(params, pre_buf, cache1)
    cache = _fix_cache_indices(cache, p_len)
    cache = tree_map(lambda a: a.repeat_interleave(beam, 0), cache)
    logp0 = torch.log_softmax(model.head_logits(params, hidden[:, p_len - 1])[0].float(), -1)
    scores0 = torch.full((beam,), float("-inf"), device=dev)
    scores0[0] = 0.0
    done0 = torch.zeros(beam, dtype=torch.bool, device=dev)
    scores, _, chosen = expand(logp0.expand(beam, vocab), scores0, done0)
    toks = torch.zeros(beam, steps, dtype=torch.long, device=dev)
    toks[:, 0] = chosen
    done = (chosen == eos_id) if eos_id is not None else done0
    prev = chosen
    for e in range(1, steps):
        logits, cache = model.apply(params, prev[:, None], cache)
        logp = torch.log_softmax(logits[:, 0].float(), -1)
        scores, parents, chosen = expand(logp, scores, done)
        if eos_id is not None:
            done = done[parents] | (chosen == eos_id)
        cache = tree_map(lambda a: a[parents], cache)
        toks = toks[parents]
        toks[:, e] = chosen
        prev = chosen
    return toks, scores


@torch.no_grad()
def beam_search(
    model,
    params,
    prompt: Sequence[int],
    steps: int,
    beam_size: int = 4,
    eos_id: Optional[int] = None,
    weights_dtype=None,
    device=None,
) -> "tuple[list, float]":
    """Beam-search decoding over the KV-cached model: the highest
    log-probability continuation of ``prompt`` found with ``beam_size``
    beams and ``steps`` expansions. Returns ``(tokens, score)``, the best
    sequence (prompt included, truncated just past the first ``eos_id``)
    and its summed log-probability; ``beam_size=1`` is greedy
    :func:`generate_fast`. ``beam_size`` may exceed the vocab."""
    _validate(model, prompt, 0.0, eos_id=eos_id)
    if beam_size < 1:
        raise ValueError(f"beam_size={beam_size} must be >= 1")
    if steps <= 0:
        return [int(t) for t in prompt], 0.0
    params, dev = _on(params, device)
    if weights_dtype is not None:
        params = cast_weights(params, weights_dtype)
    dec = _decode_setup(model, prompt, steps)
    p0 = len(prompt)
    pre_bucket = _bucket(p0, model.max_len)
    pre_buf = torch.zeros(1, pre_bucket, dtype=torch.long, device=dev)
    pre_buf[0, :p0] = torch.tensor([int(t) for t in prompt], device=dev)
    toks, scores = _beam_scan(
        dec, steps, beam_size, eos_id, params, dec.init_cache(1, dev), pre_buf, p0,
    )
    best = int(torch.argmax(scores))
    seq = [int(t) for t in prompt] + toks[best].tolist()
    return _truncate_at_eos(seq, len(prompt), eos_id), float(scores[best])


def _prefill_chunk(model, params, cache0, pre_buf, p_lens, clock0=0,
                   with_head=True):
    """The one padded-prefill recipe (the batch kernel, the Server's
    admission, the speculative decoder): the prompt buffer as one
    ``head=False`` chunk, the position counters set to each row's
    ``clock0 + p_lens[n]`` (:func:`_fix_cache_indices`), and each row's
    last prompt hidden state through the vocab head. Returns ``(cache,
    last_logits (N, V))``, or ``(cache, None)`` with ``with_head=False``."""
    hidden, cache = model.clone(head=False).apply(params, pre_buf, cache0)
    cache = _fix_cache_indices(cache, clock0 + p_lens)
    if not with_head:
        return cache, None
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    h_last = hidden[rows, p_lens.long() - 1]
    return cache, model.head_logits(params, h_last)


_COUNTERS = ("cache_index", "pos_index")


def _fix_cache_indices(cache, p_len):
    """The cache with every position counter (each block's
    ``cache_index``, the LM's ``pos_index``) set to ``p_len`` (a scalar or
    a (B,) tensor): a padded chunk over-advanced them, and the slots past
    ``p_len`` hold padding that decode overwrites before any mask exposes
    it."""

    def fix(node):
        out = {}
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                out[name] = fix(leaf)
            elif name in _COUNTERS:
                value = torch.as_tensor(p_len, device=leaf.device).to(leaf.dtype)
                out[name] = torch.broadcast_to(value, leaf.shape).clone()
            else:
                out[name] = leaf
        return out

    return fix(cache)


def _sample_rows(logits, row_keys, greedy, top_k, use_top_p, temp, top_p,
                 min_p=None, noise=None):
    """The one sampling rule of every decode path: greedy argmax, or
    temperature scale → :func:`_filter_logits` → categorical, per row of
    ``logits`` (N, V) with ``row_keys`` (N, 2). ``temp``/``top_p``/
    ``min_p`` are scalars or (N,) tensors (per-row rules); row ``n``'s math
    is the same either way. ``noise`` (N, V): the rows' Gumbel noise when
    the caller drew it ahead (a server's segment); else it is drawn here
    from ``row_keys``."""
    if greedy:
        return torch.argmax(logits, -1)
    n, dev = logits.shape[0], logits.device
    scaled = _filter_blocks(
        logits / _col(temp, n, dev), top_k,
        _col(top_p, n, dev) if use_top_p else None,
        None if min_p is None else _col(min_p, n, dev),
    )
    if noise is None:
        noise = jrandom.gumbel(row_keys, (logits.shape[-1],))
    return jrandom.categorical_from_gumbel(scaled, noise)


def _prefill_decode_scan(model, steps, greedy, top_k, use_top_p, use_min_p,
                         params, cache0, pre_buf, p_lens, keys, temp, top_p,
                         min_p):
    """Chunked-prefill decoding with per-row clocks (the reference's
    ``_prefill_decode_scan``): every row's whole prompt in one chunk, token
    0 from the prefill logits with key 0, then ``steps - 1`` ticks, tick
    ``t`` sampling with key ``t + 1``. Returns the (N, steps) tokens on the
    device."""
    cache, last = _prefill_chunk(model, params, cache0, pre_buf, p_lens)
    mp = min_p if use_min_p else None
    prev = _sample_rows(last, keys[:, 0], greedy, top_k, use_top_p, temp,
                        top_p, mp)
    out = torch.empty(prev.shape[0], steps, dtype=torch.long, device=prev.device)
    out[:, 0] = prev
    for t in range(steps - 1):
        logits, cache = model.apply(params, prev[:, None], cache)
        prev = _sample_rows(logits[:, 0], keys[:, t + 1], greedy, top_k,
                            use_top_p, temp, top_p, mp)
        out[:, t + 1] = prev
    return out


@torch.no_grad()
def generate_batch(
    model,
    params,
    prompts: "Sequence[Sequence[int]]",
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
) -> "list[list]":
    """Continue N prompts by ``steps`` tokens each in one decode loop over
    an (N, ...) K/V cache. Row ``n`` equals ``generate_fast(...,
    prompts[n], rng=fold_in(rng, n))``."""
    return _batch_impl(
        model, params, prompts, steps, temperature, seed, rng,
        top_k, top_p, weights_dtype=weights_dtype, eos_id=eos_id,
        min_p=min_p, device=device,
    )


def cast_weights(params, dtype):
    """Floating-point param leaves cast to ``dtype`` once, for serving
    (integer leaves pass through)."""
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, params)


def _truncate_at_eos(seq, p_len, eos_id):
    """Cut a generated row just past the first eos beyond the prompt."""
    if eos_id is None:
        return seq
    for i in range(p_len, len(seq)):
        if seq[i] == eos_id:
            return seq[: i + 1]
    return seq


def _batch_impl(model, params, prompts, steps, temperature, seed, rng, top_k,
                top_p, weights_dtype=None, eos_id=None, min_p=None, device=None):
    """The prologue of :func:`generate_batch`: validation, early returns,
    the per-row keys ``fold_in(rng, n)``, then :func:`_generate_rows`."""
    if len(prompts) == 0:
        return []
    for p in prompts:
        _validate(model, p, temperature, top_k, top_p, eos_id, min_p)
    if steps <= 0:
        return [[int(t) for t in p] for p in prompts]
    params, dev = _on(params, device)
    if weights_dtype is not None:
        params = cast_weights(params, weights_dtype)
    rngs = jrandom.fold_in(_keys(rng, seed, dev)[None].expand(len(prompts), 2),
                           torch.arange(len(prompts), device=dev))
    rows = _generate_rows(
        model, params, prompts, steps, temperature, rngs, top_k, top_p,
        min_p=min_p,
    )
    return [_truncate_at_eos(r, len(p), eos_id) for r, p in zip(rows, prompts)]


def _generate_rows(model, params, prompts, steps, temperature, rngs, top_k,
                   top_p, min_p=None):
    """Bucket, build the prompt buffer and key streams (:func:`_prep_rows`),
    decode, and slice each row to its prompt + ``steps`` tokens."""
    n = len(prompts)
    dec = _decode_setup(model, max(prompts, key=len), steps)
    dev = rngs.device
    nb, _, _, pre_buf, p_lens, keys = _prep_rows(prompts, steps, rngs, model.max_len)
    gen = _prefill_decode_scan(
        dec, steps, temperature == 0.0, top_k,
        top_p is not None, min_p is not None,
        params, dec.init_cache(nb, dev), pre_buf, p_lens, keys,
        np.float32(max(temperature, 1e-9)),
        np.float32(1.0 if top_p is None else top_p),
        np.float32(0.0 if min_p is None else min_p),
    )
    host = gen.cpu().tolist()
    return [
        [int(t) for t in prompts[i]] + host[i]
        for i in range(n)
    ]


def _prep_rows(prompts, steps, rngs, max_len_cap, device=None):
    """The batching prep every decode family shares (the transformer's and
    the LSTM's): power-of-two buckets, the left-aligned prompt buffer,
    per-row true lengths (pad rows are 1-token dummies), and each row's
    key stream ``split(rng_n, steps)``. Pad rows reuse row 0's rng.
    ``rngs`` (n, 2) on
    the decode device, or None for the greedy speculative path (``keys``
    None; the buffers then go to ``device``)."""
    n = len(prompts)
    nb = _bucket(n, 1 << 30)
    pre_bucket = _bucket(max(len(q) for q in prompts), max_len_cap)
    gen_bucket = _bucket(steps, max_len_cap)
    dev = rngs.device if rngs is not None else device
    keys = None
    if rngs is not None:
        if nb > n:
            rngs = torch.cat([rngs, rngs[:1].expand(nb - n, 2)])
        keys = jrandom.split(rngs, max(steps, 1))
    pre_host = np.zeros((nb, pre_bucket), np.int64)
    for i, q in enumerate(prompts):
        pre_host[i, : len(q)] = q
    p_lens = np.ones((nb,), np.int32)
    p_lens[:n] = [len(q) for q in prompts]
    return (nb, pre_bucket, gen_bucket, torch.from_numpy(pre_host).to(dev),
            torch.from_numpy(p_lens).to(dev), keys)
