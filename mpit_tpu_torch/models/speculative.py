"""Speculative decoding: a small draft LM proposes, the target verifies;
counterpart of ``mpit_tpu/models/speculative.py``.

Greedy, with the reference's exactness guarantee: the output equals
:func:`~mpit_tpu_torch.models.sampling.generate_fast`'s greedy decode of the
target alone, for any draft. Each round the draft proposes ``k`` tokens,
the target scores the ``(k+1)``-token chunk ``[prev, d_1..d_k]`` through
the same cached attention the chunked prefill uses, each row accepts its
leading matches and emits them plus the target's next token, and both
caches rewind their per-row clocks (``sampling._fix_cache_indices``): the
stale K/V past a clock is rewritten by the next chunk before any mask
exposes it.

The reference runs the loop as one ``lax.while_loop``; here it is a Python
loop of rounds that reads one flag from the device per round (whether any
row still has budget).
"""

from __future__ import annotations

from typing import Optional

import torch

from mpit_tpu_torch.models import sampling


def _spec_round(tgt, dft, k, t_params, d_params, t_cache, d_cache, prev, pos,
                active):
    """One speculative round over nb rows (the standalone loop and the
    Server's spec segment share it). Per active row: the draft proposes k
    tokens (and takes one more feed, so its cache holds the bonus path),
    the target scores the (k+1)-chunk, the row accepts ``a`` proposals and
    emits ``m = a + 1`` tokens ``t[:, :m]``, and both clocks rewind to
    ``pos + m``. Inactive rows emit 0 and keep their ``prev`` and clock.

    Returns ``(t_cache, d_cache, new_prev, new_pos, t, a, m)``, ``t``
    (nb, k+1)."""
    nb = prev.shape[0]
    p = prev
    proposals = []
    for _ in range(k):
        logits, d_cache = dft.apply(d_params, p[:, None], d_cache)
        p = torch.argmax(logits[:, 0], -1)
        proposals.append(p)
    _, d_cache = dft.apply(d_params, p[:, None], d_cache)
    d = torch.stack(proposals, 1)  # (nb, k)
    chunk = torch.cat([prev[:, None], d], 1)
    t_logits, t_cache = tgt.apply(t_params, chunk, t_cache)
    t = torch.argmax(t_logits, -1)  # (nb, k+1)
    match = torch.cumprod((d == t[:, :k]).to(torch.int32), 1)
    a = match.sum(1)
    m = torch.where(active, a + 1, 0)
    new_pos = pos + m
    t_cache = sampling._fix_cache_indices(t_cache, new_pos)
    d_cache = sampling._fix_cache_indices(d_cache, new_pos)
    new_prev = torch.where(active, t[torch.arange(nb, device=t.device), a], prev)
    return t_cache, d_cache, new_prev, new_pos, t, a, m


def _write_rows(out, t, start):
    """Row ``r`` of ``t`` written into row ``r`` of ``out`` at
    ``start[r]``, the start clamped to ``[0, width - t.width]`` as
    ``dynamic_update_slice`` clamps it."""
    width = t.shape[1]
    start = torch.clamp(start, 0, out.shape[1] - width)
    cols = start[:, None] + torch.arange(width, device=out.device)
    rows = torch.arange(out.shape[0], device=out.device)[:, None]
    out[rows, cols] = t
    return out


def _spec_loop(tgt, dft, k, gen_bucket, limit, t_params, d_params, t_cache,
               d_cache, pre_buf, p_lens):
    """The speculative loop over N greedy rows (the reference's
    ``_spec_loop``): both models prefill, token 0 is the target's argmax,
    then rounds run until every row has ``limit`` (= steps) tokens; rows
    that reach it freeze and ride along, their writes clamped into the
    margin past ``gen_bucket``. Returns ``(out, n, rounds)``."""
    nb = pre_buf.shape[0]
    dev = pre_buf.device
    t_cache, t_last = sampling._prefill_chunk(tgt, t_params, t_cache, pre_buf, p_lens)
    d_cache, _ = sampling._prefill_chunk(dft, d_params, d_cache, pre_buf, p_lens,
                                         with_head=False)
    prev = torch.argmax(t_last, -1)
    out = torch.zeros(nb, gen_bucket + k + 1, dtype=torch.long, device=dev)
    out[:, 0] = prev
    pos = p_lens.long()
    n = torch.ones(nb, dtype=torch.long, device=dev)
    rounds = 0
    while bool((n < limit).any()):
        active = n < limit
        t_cache, d_cache, prev, pos, t, _a, m = _spec_round(
            tgt, dft, k, t_params, d_params, t_cache, d_cache, prev, pos, active)
        out = _write_rows(out, t, torch.where(active, n, gen_bucket))
        n = n + m
        rounds += 1
    return out, n, rounds


@torch.no_grad()
def generate_speculative(
    model,
    params,
    draft_model,
    draft_params,
    prompt,
    steps: int,
    k: int = 4,
    eos_id: Optional[int] = None,
    weights_dtype=None,
    return_stats: bool = False,
    device=None,
):
    """Greedy-decode ``steps`` tokens from the target ``model`` with
    ``draft_model`` proposing ``k`` tokens per verification chunk. Equals
    ``generate_fast(model, params, prompt, steps, eos_id=eos_id)`` for any
    draft. ``len(prompt) + steps + k`` must fit both models' ``max_len``.
    ``return_stats``: also ``{"iterations", "mean_emitted"}`` (chunks run,
    tokens emitted per chunk)."""
    rows, stats = _run_spec(
        model, params, draft_model, draft_params, [prompt], steps, k,
        eos_id, weights_dtype, device,
    )
    return (rows[0], stats) if return_stats else rows[0]


@torch.no_grad()
def generate_speculative_batch(
    model,
    params,
    draft_model,
    draft_params,
    prompts,
    steps: int,
    k: int = 4,
    eos_id: Optional[int] = None,
    weights_dtype=None,
    device=None,
):
    """N prompts through one speculative loop, each row accepting at its
    own rate; row ``n`` equals its solo :func:`generate_speculative`."""
    if len(prompts) == 0:
        return []
    rows, _ = _run_spec(
        model, params, draft_model, draft_params, list(prompts), steps,
        k, eos_id, weights_dtype, device,
    )
    return rows


def _run_spec(model, params, draft_model, draft_params, prompts, steps, k,
              eos_id, weights_dtype, device):
    """The shared prologue and loop call of the solo and batch entries."""
    for q in prompts:
        sampling._validate(model, q, 0.0, None, None, eos_id)
        sampling._validate(draft_model, q, 0.0, None, None, None)
    if draft_model.vocab_size != model.vocab_size:
        raise ValueError(
            f"draft vocab {draft_model.vocab_size} != target vocab "
            f"{model.vocab_size}"
        )
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    if steps <= 0:
        rows = [[int(t) for t in q] for q in prompts]
        return rows, {"iterations": 0, "mean_emitted": 0.0}
    longest = max(len(q) for q in prompts)
    for m, name in ((model, "target"), (draft_model, "draft")):
        if longest + steps + k > m.max_len:
            raise ValueError(
                f"prompt+steps+k = {longest + steps + k} exceeds the "
                f"{name} model's max_len={m.max_len} (the verification "
                "chunk needs k slots of headroom)"
            )
    params, dev = sampling._on(params, device)
    draft_params, _ = sampling._on(draft_params, device)
    if weights_dtype is not None:
        params = sampling.cast_weights(params, weights_dtype)
        draft_params = sampling.cast_weights(draft_params, weights_dtype)
    tgt = model.clone(decode=True)
    dft = draft_model.clone(decode=True)
    n_real = len(prompts)
    nb, _, gen_bucket, pre_buf, p_lens, _ = sampling._prep_rows(
        prompts, steps, None, min(model.max_len, draft_model.max_len), device=dev
    )
    out, n, iters = _spec_loop(
        tgt, dft, k, gen_bucket, steps, params, draft_params,
        tgt.init_cache(nb, dev), dft.init_cache(nb, dev),
        pre_buf, p_lens,
    )
    host = out.cpu().tolist()
    rows = [
        sampling._truncate_at_eos(
            [int(t) for t in prompts[i]] + host[i][:steps], len(prompts[i]), eos_id,
        )
        for i in range(n_real)
    ]
    total = int(n.sum()) if iters else 0
    stats = {
        "iterations": iters,
        # n counts each row's token 0 plus every chunk's emissions; the
        # denominator is chunk-rows, pad and frozen rows included
        "mean_emitted": (total - nb) / (iters * nb) if iters else 0.0,
    }
    return rows, stats
