"""Continuous-batching serving loop over the KV-cached decode path;
counterpart of ``mpit_tpu/models/serving.py`` (``Server``, ``RNNServer``).

The K/V cache (an LSTM's carries, for :class:`RNNServer`) is resident on
the device: one ``(NB, ...)`` cache tree lives across the server's life,
one slot per decode row. Decoding advances in segments of ticks over the
whole batch, and the host steps in only at segment boundaries: it retires
finished rows (budget spent or ``eos_id`` emitted) and admits queued
requests into freed slots with one chunked prefill per same-bucket group,
whose cache rows are copied into the resident tree in place. In-flight
rows are untouched; free slots keep ticking garbage that no occupied row
can attend (their writes clamp at the cache's end, as XLA clamps them).

Every request's result equals its solo ``generate_fast(prompt, max_new,
rng=request_rng)`` (``generate_rnn`` for the RNN server): the request's
keys are split once at submit (``split(rng, max_new)``) and generated
token ``j`` is drawn with key ``j`` whatever the scheduling. A segment's
tokens stay on the device until the boundary: one host fetch per
boundary, none per tick.

The reference compiles each segment once per segment length and donates
the resident buffers to it. Here a segment reads and writes only resident
tensors: the cache tree (whose clocks, or an LSTM's carries, each tick
rebuilds, so the segment copies the last ones back into the tree), the
previous tokens, the server's own copy of the weights, and static input
and output buffers (the key columns, the per-row temperatures and top-p,
the tokens). On the card (``capture=None``) the first segment of a length
runs eagerly as a warm-up, the second is captured as a CUDA graph, and
that graph is replayed from then on (``parallel/capture.py``
``GraphSet``); the speculative server captures one round and replays it
as many times as the boundary's round count. Admission (the prefill and
the row insertion) stays on the host between segments. A segment or
admission that fails part way leaves the resident buffers half updated,
and the server is poisoned as the reference's is: finished results stay
readable through :meth:`Server.results`.

Observability (``Server(obs=ObsConfig(dir=...))``): the reference's
request lifecycle (``req_enqueue`` → ``req_admit`` → ``req_first_token``
→ ``req_finish``/``req_cancel``) and per-boundary ``prefill``/
``segment`` records go to ``<dir>/obs_rank0.jsonl`` through the port's
:mod:`mpit_tpu_torch.obs` Journal, read by ``python -m mpit_tpu_torch.obs
slo``; with obs off every hook is one ``is None`` check.
"""

from __future__ import annotations

import copy
import itertools
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from mpit_tpu_torch import random as jrandom
from mpit_tpu_torch.models import sampling
from mpit_tpu_torch.obs.live import (
    M_E2E,
    M_OCCUPIED,
    M_REQ_CANCELLED,
    M_REQ_FINISHED,
    M_REQ_SUBMITTED,
    M_SEGMENTS,
    M_SERVE_FAULTS,
    M_SLO_MISSES,
    M_TOKENS,
    M_TTFT,
    M_WAITING,
)
from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.utils.params import tree_leaves, tree_leaves_with_path, tree_map


class _ServeObs:
    """Per-server request-lifecycle recorder: one rank-0 obs Journal
    (serving is single-process) in the standard ``obs_rank*.jsonl``
    layout, so merge/summary/slo all read a load run unchanged. Built
    only when obs is armed — the disabled Server carries ``None`` and
    every instrumentation site stays a bare identity check.

    With ``ObsConfig.live`` armed, the same lifecycle events also feed a
    live :class:`mpit_tpu_torch.obs.live.MetricsRegistry` (role ``"serve"``)
    snapshotted to ``<dir>/live/rank_0.json`` — submitted/finished/
    cancelled counters, TTFT/e2e rolling histograms, SLO-miss counts
    (against each request's own ``slo_ms``), and waiting/occupied gauges
    per segment. That is the SLO-burn signal the online alert engine and
    a future replica router read while traffic is flowing."""

    __slots__ = ("journal", "clock", "registry", "_live", "_open_reqs")

    def __init__(self, config):
        from mpit_tpu_torch.obs.core import Journal, LogicalClock

        if not getattr(config, "dir", None):
            raise ValueError(
                "serving obs needs a journal directory: pass "
                "ObsConfig(dir=...) (counters-only mode has nothing to "
                "record request lifecycles into)"
            )
        os.makedirs(config.dir, exist_ok=True)
        box = None
        if getattr(config, "blackbox", False):
            from mpit_tpu_torch.obs.blackbox import BlackBox

            box = BlackBox(
                config.dir, 0,
                max_records=getattr(config, "blackbox_records", 2048),
                max_seconds=getattr(config, "blackbox_seconds", 30.0),
            )
        self.journal = Journal(
            os.path.join(config.dir, "obs_rank0.jsonl"), 0,
            max_records=getattr(config, "max_records", None),
            mode="ring" if getattr(config, "ring", False) else "cap",
            blackbox=box,
        )
        self.clock = LogicalClock()
        self.registry = None
        self._live = None
        self._open_reqs: dict = {}  # rid -> (t_enqueue, slo_ms)
        if getattr(config, "live", False):
            from mpit_tpu_torch.obs.live import LiveExporter, MetricsRegistry

            self.registry = MetricsRegistry(0, role="serve")
            self._live = LiveExporter(
                self.registry,
                os.path.join(config.dir, "live"),
                interval_s=getattr(config, "live_interval", 1.0),
            )

    def event(self, ev: str, **fields) -> None:
        self._lifecycle(ev, fields)
        self.journal.event(ev, self.clock.tick(), **fields)
        if self.registry is not None:
            self._publish(ev, fields)

    def _lifecycle(self, ev: str, fields: dict) -> None:
        """Tag lifecycle records with the latencies this recorder already
        measures (monotonic, enqueue → first token / finish):
        ``req_first_token`` gains ``ttft_ms``, ``req_finish`` gains
        ``e2e_ms`` + ``slo_miss`` (vs the request's own ``slo_ms``). The
        tags land in the JOURNAL record itself — a black-box dump or a
        capped journal is then post-mortem-able on its face, without
        replaying the whole request stream to re-derive latencies."""
        now = time.monotonic()
        if ev == "req_enqueue":
            self._open_reqs[fields.get("rid")] = (now, fields.get("slo_ms"))
        elif ev == "req_first_token":
            open_rec = self._open_reqs.get(fields.get("rid"))
            if open_rec is not None:
                fields["ttft_ms"] = round((now - open_rec[0]) * 1e3, 3)
        elif ev == "req_finish":
            open_rec = self._open_reqs.pop(fields.get("rid"), None)
            if open_rec is not None:
                e2e_ms = (now - open_rec[0]) * 1e3
                fields["e2e_ms"] = round(e2e_ms, 3)
                slo_ms = open_rec[1]
                if slo_ms is not None:
                    fields["slo_miss"] = bool(e2e_ms > slo_ms)
        elif ev == "req_cancel":
            self._open_reqs.pop(fields.get("rid"), None)

    def _publish(self, ev: str, fields: dict) -> None:
        """Fold one journal event into the live registry, reusing the
        latencies :meth:`_lifecycle` already stamped into the record —
        the live plane must not depend on the journal surviving or
        being re-read."""
        reg = self.registry
        if ev == "req_enqueue":
            reg.inc(M_REQ_SUBMITTED)
        elif ev == "req_first_token":
            if "ttft_ms" in fields:
                reg.observe(M_TTFT, fields["ttft_ms"] / 1e3)
        elif ev == "req_finish":
            reg.inc(M_REQ_FINISHED)
            reg.inc(M_TOKENS, float(fields.get("gen", 0)))
            if "e2e_ms" in fields:
                reg.observe(M_E2E, fields["e2e_ms"] / 1e3)
                if fields.get("slo_miss"):
                    reg.inc(M_SLO_MISSES)
        elif ev == "req_cancel":
            reg.inc(M_REQ_CANCELLED)
        elif ev == "segment":
            reg.inc(M_SEGMENTS)
            if "waiting" in fields:
                reg.set_gauge(M_WAITING, fields["waiting"])
            if "occupied" in fields:
                reg.set_gauge(M_OCCUPIED, fields["occupied"])
        elif ev == "serve_fault":
            reg.inc(M_SERVE_FAULTS)

    def close(self) -> None:
        self.journal.close()
        if self._live is not None:
            self._live.close()


def _prefill_rows(model, pre_bucket, greedy, top_k, use_top_p, params, cache0,
                  pre_buf, p_lens, keys0, temp, top_p, clock0):
    """Admission: a group of same-bucket prompts through the chunked
    prefill at once; returns their cache rows (each row's clocks at its own
    global position) and each row's first token, drawn with its stream's
    key 0. ``clock0``: 0 for a fresh cache, the prefix length when
    ``cache0`` holds copies of the prefix template."""
    cache, last = sampling._prefill_chunk(model, params, cache0, pre_buf,
                                          p_lens, clock0)
    tok0 = sampling._sample_rows(last, keys0, greedy, top_k, use_top_p, temp,
                                 top_p)
    return cache, tok0


def _prefill_prefix(model, pre_bucket, params, cache0, pre_buf, p_len):
    """Cache-only prefill (the prefix template, the draft's admission rows)."""
    cache, _ = sampling._prefill_chunk(model, params, cache0, pre_buf, p_len,
                                       with_head=False)
    return cache


def _tile_rows(kb, tpl):
    """The batch-1 template repeated into a ``kb``-row cache tree."""
    return tree_map(lambda x: x.repeat_interleave(kb, 0), tpl)


def _serve_spec_round(tgt, dft, k, t_params, d_params, t_cache, d_cache,
                      prev, pos, active, out, n):
    """One round of the reference's ``_serve_spec_segment`` loop
    (``speculative._spec_round``) over the whole resident batch, in place:
    both caches' clocks, ``prev`` and ``pos`` (each row's cached-token
    count; free slots start from 0, which keeps their clocks from drifting
    to the end) move on, and the round's tokens land in ``out`` at each
    row's count ``n``, which grows by what the row emitted."""
    from mpit_tpu_torch.models.speculative import _spec_round, _write_rows

    t_new, d_new, new_prev, new_pos, t, _a, m = _spec_round(
        tgt, dft, k, t_params, d_params, t_cache, d_cache, prev, pos, active)
    _write_rows(out, t, n)
    n.add_(m)
    pos.copy_(new_pos)
    prev.copy_(new_prev)
    _write_back(t_cache, t_new)
    _write_back(d_cache, d_new)


def _write_back(resident, new) -> None:
    """Copy into ``resident``'s tensors every tensor of ``new`` (a tree of
    the same shape) that is not one of them: the clocks a decode step
    rebuilt (``pos_index``, each block's ``cache_index``) or an LSTM's
    carries. The resident tree then holds the new state in the tensors a
    graph was captured over."""
    for r, x in zip(tree_leaves(resident), tree_leaves(new), strict=True):
        if x is not r:
            r.copy_(x)


def _insert_rows(big, rows, slots):
    """Copy K prefilled cache rows into slots ``slots`` of the resident
    tree in place (every leaf is batch-leading, the clocks included). Pad
    rows repeat row 0's inputs and slot, so their duplicate writes carry
    the same values."""
    for b, r in zip(tree_leaves(big), tree_leaves(rows)):
        b.index_copy_(0, slots, r.to(b.dtype))
    return big


def _serve_segment(model, seg, greedy, top_k, use_top_p, params, cache, prev,
                   keys, temp, top_p, toks):
    """``seg`` decode ticks over the whole resident batch: each tick feeds
    every slot its previous token and draws the next with the slot's key
    column (the segment's Gumbel noise is drawn once, up front). Tick
    ``t``'s tokens go to ``toks[:, t]``; the cache and ``prev`` are
    updated in place."""
    noise = None
    if not greedy:
        noise = jrandom.gumbel(keys, (model.vocab_size,))  # (NB, seg, V)
    cur, state = prev, cache
    for t in range(seg):
        logits, state = model.apply(params, cur[:, None], state)
        cur = sampling._sample_rows(
            logits[:, 0], None, greedy, top_k, use_top_p, temp, top_p,
            noise=None if noise is None else noise[:, t])
        toks[:, t] = cur
    prev.copy_(cur)
    _write_back(cache, state)


def _own_modules(model):
    """``model`` with module objects of its own around the same parameter
    tensors. ``Model.apply`` (``torch.func.functional_call``) swaps the
    parameters on the module objects while it runs, so two servers that
    share them, each in a thread of its own (a fleet's replicas), would
    run on each other's weights."""
    shared = itertools.chain(model.parameters(), model.buffers())
    return copy.deepcopy(model, {id(t): t for t in shared})


def _bf16_weights(weights_dtype) -> bool:
    return weights_dtype in ("bf16", torch.bfloat16)


class Server:
    """Continuous-batching decode server for one model and its params (the
    reference's ``Server``, argument for argument; see its docstring).

    ``max_batch`` decode slots; ``segment`` ticks between scheduling
    points; ``temperature``/``top_k``/``top_p``/``eos_id`` the default rule
    (temperature and top_p may be overridden per request, greedy vs
    sampling and top-k are fixed here); ``prefix`` a shared prompt prefix
    prefilled once into a batch-1 template; ``draft_model``/
    ``draft_params`` speculative serving (greedy only, ``spec_k``
    proposals, ``spec_rounds`` rounds per boundary); ``obs`` an
    :class:`~mpit_tpu_torch.obs.core.ObsConfig` with ``dir`` set;
    ``weights_dtype="bf16"`` casts the weights once. The server runs on
    the card unless ``device="cpu"``.

    ``capture`` as a trainer's: None replays each segment length's graph
    where nothing stands in the way (:attr:`eager_reasons` says what
    does: on the CPU, the device), False never captures, True must (and
    raises, with the reasons, where it cannot). A capturing server serves
    from weights in storage of its own (a copy where the caller's tensors
    are already on its device in its dtype: ``owned_weight_bytes``), into
    which :meth:`install_weights` copies a push."""

    def __init__(
        self,
        model,
        params,
        max_batch: int = 8,
        segment: int = 32,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_id: Optional[int] = None,
        weights_dtype=None,
        seed: int = 0,
        prefix=None,
        draft_model=None,
        draft_params=None,
        spec_k: int = 4,
        spec_rounds: int = 4,
        obs=None,
        device=None,
        capture: Optional[bool] = None,
    ):
        from mpit_tpu_torch.parallel import capture as graphs

        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if segment < 1:
            raise ValueError("segment must be >= 1")
        if prefix is not None and len(prefix) == 0:
            prefix = None
        if prefix is not None:
            sampling._validate(model, prefix, 0.0, None, None, None)
        if draft_model is not None:
            if getattr(model, "max_len", None) is None:
                raise ValueError(
                    "speculative serving needs a transformer-style "
                    "target (chunk verification scores k+1 positions "
                    "in parallel; a recurrence cannot)"
                )
            if temperature != 0.0 or top_k is not None or top_p is not None:
                raise ValueError(
                    "speculative serving (draft_model=...) is greedy: "
                    "temperature must be 0 and top_k/top_p None"
                )
            if prefix is not None:
                raise ValueError(
                    "draft_model and prefix cannot combine yet — the "
                    "draft cache has no prefix template"
                )
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_model.vocab_size} != target "
                    f"vocab {model.vocab_size}"
                )
            if draft_model.max_len < model.max_len:
                raise ValueError(
                    "draft max_len must cover the target's (both caches "
                    f"hold the same sequence): {draft_model.max_len} < "
                    f"{model.max_len}"
                )
            if spec_k < 1 or spec_rounds < 1:
                raise ValueError("spec_k and spec_rounds must be >= 1")
        self.model = model
        self._weights_dtype = weights_dtype
        self.device = resolve_device(device)
        self.eager_reasons = graphs.device_reasons(self.device)
        self.capture = graphs.resolve(capture, self.eager_reasons)
        self._graphs = graphs.GraphSet(self.device) if self.capture else None
        self.owned_weight_bytes = 0
        self.params = self._weights(params, own=self.capture)
        self._weights_version = 0
        self.max_batch = int(max_batch)
        self.segment = int(segment)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self._rng = jrandom.key(seed, self.device)
        self._poisoned: Optional[BaseException] = None
        self._next_id = 0
        self._waiting: deque[dict] = deque()
        self._results: dict[int, list[int]] = {}
        self.segments_run = 0
        # None for carry-decode RNNs: no positional horizon, no caps
        self._max_len = getattr(model, "max_len", None)
        self._dec = _own_modules(model).clone(decode=True)
        self._nb = sampling._bucket(self.max_batch, 1 << 30)
        self._slots: list = [None] * self._nb
        self._cache = None  # built at first admission
        self._prev = None
        self.prefix = [int(t) for t in prefix] if prefix is not None else None
        self._template = None
        self._greedy = self.temperature == 0.0
        self.spec_k = int(spec_k)
        self.spec_rounds = int(spec_rounds)
        self._dft = (_own_modules(draft_model).clone(decode=True)
                     if draft_model is not None else None)
        self._d_params = None
        if draft_params is not None:
            self._d_params = self._weights(draft_params, own=self.capture)
        self._d_cache = None
        # static buffers of the segments (built at first admission): the
        # tokens, the rows' temperatures and top-p, the key columns by
        # segment length; the speculative rounds' out, n, pos and active
        self._toks = self._temps = self._tops = None
        self._keys: dict = {}
        self._spec = None
        self._obs = _ServeObs(obs) if obs is not None else None

    # ---- model-family hooks (the RNN server overrides these two) ----

    def _prefill_call(self, pre_bucket, cache0, pre_buf, p_lens, keys0, temps,
                      tops, pfx):
        """The admission prefill: (cache rows, first tokens)."""
        return _prefill_rows(
            self._dec, pre_bucket, self._greedy, self.top_k,
            self.top_p is not None, self.params, cache0, pre_buf, p_lens,
            keys0, temps, tops, pfx,
        )

    def _template_call(self, pb, buf, p_len):
        """The one-time prefix-template prefill (cache only)."""
        return _prefill_prefix(self._dec, pb, self.params,
                               self._dec.init_cache(1, self.device),
                               buf, p_len)

    def _len_cap(self, pfx=0) -> int:
        """Bucket cap for prompt chunks: the cache headroom above the
        prefix clock, or unbounded for horizon-free RNNs."""
        return (self._max_len - pfx) if self._max_len else (1 << 30)

    # ----------------------------------------------------- weight refresh

    @property
    def weights_version(self) -> int:
        """The version stamp of the weights serving now (0 = the
        construction-time weights)."""
        return self._weights_version

    def _weights(self, params, own: bool):
        """``params`` as this server serves them: on its device, cast once
        by ``weights_dtype``; with ``own``, a leaf that the move and the
        cast left in the caller's storage is copied (its bytes counted in
        ``owned_weight_bytes``)."""
        moved, _ = sampling._on(params, self.device)
        if _bf16_weights(self._weights_dtype):
            moved = sampling.cast_weights(moved, torch.bfloat16)
        if not own:
            return moved

        def owned(src, x):
            if x.device != src.device or x.data_ptr() != src.data_ptr():
                return x
            self.owned_weight_bytes += x.numel() * x.element_size()
            return x.clone()

        return tree_map(owned, params, moved)

    def install_weights(self, params, version: Optional[int] = None) -> int:
        """Swap in new weights between scheduling steps, with the
        construction's ``weights_dtype`` cast; in-flight requests finish
        under the new weights. ``version`` must move forward (None: +1).
        A push must match the served weights leaf for leaf in shape and
        dtype. A capturing server copies it into its own weights' storage,
        which its graphs read; the caller's tensors are never written.
        Returns the installed version."""
        if version is None:
            version = self._weights_version + 1
        version = int(version)
        if version <= self._weights_version:
            raise ValueError(
                f"weights version must advance: {version} <= "
                f"{self._weights_version} (rolling refreshes are "
                "monotonic — the audit trail depends on it)"
            )
        self._check_poisoned()
        new = self._weights(params, own=False)
        have = tree_leaves_with_path(self.params)
        got = tree_leaves_with_path(new)
        for (path, a), (pushed, b) in itertools.zip_longest(have, got, fillvalue=(None, None)):
            if path != pushed or a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    f"weight push does not match the served weights at {path or pushed}: "
                    f"{None if a is None else (tuple(a.shape), a.dtype)} served, "
                    f"{None if b is None else (tuple(b.shape), b.dtype)} pushed")
        if self._graphs is None:
            self.params = new
        else:
            for (_, a), (_, b) in zip(have, got):
                a.copy_(b)
        self._weights_version = version
        if self._obs is not None:
            self._obs.event("weights_install", version=version)
        return version

    # ------------------------------------------------------------- intake

    def submit(self, prompt, max_new_tokens: int, rng=None, seed=None,
               temperature=None, top_p=None, slo_ms=None) -> int:
        """Queue a request; returns its id. Its key stream is fixed here
        (``rng``, ``key(seed)``, or ``fold_in(server_rng, id)``), so its
        result does not depend on scheduling. ``temperature``/``top_p``
        override the server's rule for this request; ``slo_ms`` is its
        end-to-end deadline, journaled for ``obs slo``."""
        if temperature is not None:
            if self._greedy:
                raise ValueError(
                    "per-request temperature needs a sampling server "
                    "(constructed with temperature > 0); greedy is a "
                    "server-level mode"
                )
            if temperature <= 0:
                raise ValueError(
                    f"per-request temperature={temperature} must be > 0"
                )
        if top_p is not None and self.top_p is None:
            raise ValueError(
                "per-request top_p needs nucleus sampling enabled at "
                "construction (top_p=...)"
            )
        eff_temp = self.temperature if temperature is None else temperature
        eff_tp = self.top_p if top_p is None else top_p
        sampling._validate(self.model, prompt, eff_temp, self.top_k, eff_tp,
                           self.eos_id)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if slo_ms is not None and slo_ms <= 0:
            raise ValueError(f"slo_ms={slo_ms} must be > 0")
        pfx = len(self.prefix) if self.prefix else 0
        if (self._max_len is not None
                and pfx + len(prompt) + max_new_tokens > self._max_len):
            raise ValueError(
                f"prefix ({pfx}) + prompt ({len(prompt)}) + "
                f"max_new_tokens ({max_new_tokens}) exceeds "
                f"max_len={self._max_len} "
                "(the cached decode cannot slide)"
            )
        if (self._dft is not None
                and len(prompt) + max_new_tokens + self.spec_k > self._max_len):
            raise ValueError(
                f"prompt + max_new_tokens + spec_k = "
                f"{len(prompt) + max_new_tokens + self.spec_k} exceeds "
                f"max_len={self._max_len} (the verification chunk "
                "needs spec_k slots of headroom)"
            )
        self._check_poisoned()
        rid = self._next_id
        self._next_id += 1
        if rng is None:
            rng = (jrandom.key(seed, self.device) if seed is not None
                   else jrandom.fold_in(self._rng, rid))
        else:
            rng = torch.as_tensor(rng).to(self.device)
        self._waiting.append({
            "id": rid,
            # the accepted sequence, prefix included
            "known": (self.prefix or []) + [int(t) for t in prompt],
            "max_new": int(max_new_tokens),
            "gen": 0,
            "temp": max(eff_temp, 1e-9),
            "tp": 1.0 if eff_tp is None else eff_tp,
            # the request's whole stream: generated token j draws key j
            "stream": jrandom.split(rng, max_new_tokens),
        })
        if self._obs is not None:
            self._obs.event(
                "req_enqueue", rid=rid, p_len=len(prompt) + pfx,
                max_new=int(max_new_tokens),
                **({} if slo_ms is None else {"slo_ms": float(slo_ms)}),
            )
        return rid

    def cancel(self, request_id: int) -> bool:
        """Drop a queued request or free its slot mid-flight (its tokens
        are discarded). False for finished or unknown ids."""
        for i, r in enumerate(self._waiting):
            if r["id"] == request_id:
                del self._waiting[i]
                if self._obs is not None:
                    self._obs.event("req_cancel", rid=request_id, where="queued")
                return True
        for slot, r in enumerate(self._slots):
            if r is not None and r["id"] == request_id:
                self._slots[slot] = None
                if self._obs is not None:
                    self._obs.event("req_cancel", rid=request_id, where="slot",
                                    gen=r["gen"])
                return True
        return False

    # ---------------------------------------------------------- scheduling

    def _check_poisoned(self) -> None:
        """After a segment or admission failed part way, the resident
        cache and ``prev`` may be half updated; every later call says so.
        Completed results stay available through :meth:`results`."""
        if self._poisoned is not None:
            raise RuntimeError(
                "Server is poisoned: a segment or admission failed or was "
                "interrupted part way, leaving the resident decode state "
                "half updated. Completed results remain available via "
                "results(); build a new Server to resubmit the rest."
            ) from self._poisoned

    def results(self) -> dict:
        """Pop every completed request's tokens ({id: tokens}); works on a
        poisoned server too."""
        out, self._results = self._results, {}
        return out

    @property
    def pending(self) -> int:
        occupied = sum(1 for s in self._slots if s is not None)
        return len(self._waiting) + occupied

    def _occupied(self):
        return [s for s in self._slots if s is not None]

    def _admit_group(self, grp: list) -> None:
        """Prefill a same-bucket group of newcomers [(request, slot)] at
        once and copy their cache rows and first tokens into the resident
        state; in-flight slots are untouched. The group's row count
        buckets to a power of two, pad rows mirroring row 0. With a
        ``prefix`` each row prefills only its suffix, from copies of the
        prefix template."""
        t_pre = time.perf_counter() if self._obs is not None else 0.0
        dev = self.device
        if self._cache is None:
            self._cache = self._dec.init_cache(self._nb, dev)
            self._prev = torch.zeros(self._nb, dtype=torch.long, device=dev)
            self._toks = torch.zeros(self._nb, self.segment, dtype=torch.long, device=dev)
            self._temps = torch.ones(self._nb, dtype=torch.float32, device=dev)
            self._tops = torch.ones(self._nb, dtype=torch.float32, device=dev)
        pfx = len(self.prefix) if self.prefix else 0
        if self.prefix and self._template is None:
            pb = sampling._bucket(pfx, self._len_cap())
            buf = np.zeros((1, pb), np.int64)
            buf[0, :pfx] = self.prefix
            self._template = self._template_call(
                pb, torch.from_numpy(buf).to(dev),
                torch.tensor([pfx], dtype=torch.int32, device=dev))
        k = len(grp)
        kb = sampling._bucket(k, 1 << 30)
        # the suffix bucket must fit above the prefix clock (a larger one
        # would clamp the K/V write into the prefix rows)
        pre_bucket = sampling._bucket(
            max(len(r["known"]) - pfx for r, _ in grp), self._len_cap(pfx))
        pre_buf = np.zeros((kb, pre_bucket), np.int64)
        p_lens = np.zeros((kb,), np.int32)
        slots = np.zeros((kb,), np.int64)
        temps = np.ones((kb,), np.float32)
        tops = np.ones((kb,), np.float32)
        keys0 = []
        for i, (r, slot) in enumerate(grp):
            p = r["known"][pfx:]
            pre_buf[i, : len(p)] = p
            p_lens[i] = len(p)
            slots[i] = slot
            temps[i] = r["temp"]
            tops[i] = r["tp"]
            keys0.append(r["stream"][0])
        for i in range(k, kb):  # pad rows mirror row 0 exactly
            pre_buf[i] = pre_buf[0]
            p_lens[i] = p_lens[0]
            slots[i] = slots[0]
            temps[i] = temps[0]
            tops[i] = tops[0]
            keys0.append(grp[0][0]["stream"][0])
        cache0 = (_tile_rows(kb, self._template) if self.prefix
                  else self._dec.init_cache(kb, dev))
        pre_t = torch.from_numpy(pre_buf).to(dev)
        lens_t = torch.from_numpy(p_lens).to(dev)
        slots_t = torch.from_numpy(slots).to(dev)
        rows, tok0 = self._prefill_call(
            pre_bucket, cache0, pre_t, lens_t, torch.stack(keys0),
            torch.from_numpy(temps).to(dev), torch.from_numpy(tops).to(dev), pfx)
        self._cache = _insert_rows(self._cache, rows, slots_t)
        if self._dft is not None:
            # the draft prefills the same prompts (cache only) into its own
            # resident tree at the same slots
            if self._d_cache is None:
                self._d_cache = self._dft.init_cache(self._nb, dev)
            d_rows = _prefill_prefix(self._dft, pre_bucket, self._d_params,
                                     self._dft.init_cache(kb, dev),
                                     pre_t, lens_t)
            self._d_cache = _insert_rows(self._d_cache, d_rows, slots_t)
        self._prev.index_copy_(0, slots_t[:k], tok0[:k])
        host0 = tok0[:k].cpu().tolist()
        o = self._obs
        if o is not None:
            # the fetch above proves completion: the duration is real
            o.event("prefill", k=k, bucket=pre_bucket,
                    dur=time.perf_counter() - t_pre)
        for i, (r, slot) in enumerate(grp):
            t0 = int(host0[i])
            r["known"].append(t0)
            r["gen"] = 1
            done_eos = self.eos_id is not None and t0 == self.eos_id
            if o is not None:
                o.event("req_admit", rid=r["id"], slot=slot)
                o.event("req_first_token", rid=r["id"])
            if done_eos or r["gen"] >= r["max_new"]:
                self._results[r["id"]] = r["known"]  # done at admission
                if o is not None:
                    o.event("req_finish", rid=r["id"], gen=r["gen"],
                            reason="eos" if done_eos else "budget")
            else:
                self._slots[slot] = r

    @torch.no_grad()
    def step(self) -> None:
        """One scheduling round: admit into free slots, run one segment,
        retire finished rows. A failure part way poisons the server."""
        self._check_poisoned()
        try:
            self._step_inner()
        except BaseException as e:
            self._poisoned = e
            raise

    def _step_inner(self) -> None:
        # admission: FIFO waiters into free slots, grouped by prompt bucket
        free = [s for s in range(min(self._nb, self.max_batch))
                if self._slots[s] is None]
        groups: dict[int, list] = {}
        pfx = len(self.prefix) if self.prefix else 0
        for slot in free:
            if not self._waiting:
                break
            r = self._waiting.popleft()
            b = sampling._bucket(len(r["known"]) - pfx, self._len_cap(pfx))
            groups.setdefault(b, []).append((r, slot))
        for grp in groups.values():
            self._admit_group(grp)
        occ = self._occupied()
        if not occ:
            return
        if self._dft is not None:
            self._spec_step(occ)
            return
        # the max_len frontier caps the segment (rounded down to a power of
        # two), and so does the largest remaining budget (rounded up)
        frontier = (min(self._max_len - len(r["known"]) for r in occ)
                    if self._max_len is not None else 1 << 30)
        need = max(r["max_new"] - r["gen"] for r in occ)
        cap = min(self.segment, 1 << (frontier.bit_length() - 1),
                  1 << max(need - 1, 0).bit_length())
        seg = 1 << (cap.bit_length() - 1)
        t_seg = time.perf_counter() if self._obs is not None else 0.0
        # the segment's inputs into its static buffers, one copy each
        dummy = self._stream_slice(occ[0], seg)
        keys = self._keys.get(seg)
        if keys is None:
            keys = self._keys[seg] = torch.empty(self._nb, seg, 2, dtype=torch.int64,
                                                 device=self.device)
        torch.stack([self._stream_slice(r, seg) if r is not None else dummy
                     for r in self._slots], out=keys)
        self._temps.copy_(torch.tensor([1.0 if r is None else r["temp"] for r in self._slots],
                                       dtype=torch.float32))
        self._tops.copy_(torch.tensor([1.0 if r is None else r["tp"] for r in self._slots],
                                      dtype=torch.float32))
        self._run(("segment", seg), [keys], lambda: _serve_segment(
            self._dec, seg, self._greedy, self.top_k, self.top_p is not None,
            self.params, self._cache, self._prev, keys, self._temps, self._tops,
            self._toks))
        self.segments_run += 1
        self._harvest(self._toks[:, :seg].cpu().tolist(), [seg] * self._nb)
        if self._obs is not None:
            self._segment_event(t_seg, seg, len(occ))

    def _run(self, name, inputs: list, body) -> None:
        """``body()`` eagerly, or through its graph (``name``) on a
        capturing server; ``inputs`` are the static buffers it reads
        beside the resident state."""
        if self._graphs is None:
            body()
            return
        self._graphs.run(name, tree_leaves(
            (self.params, self._d_params, self._cache, self._d_cache, self._prev,
             self._toks, self._temps, self._tops, inputs)), body)

    @property
    def replays(self) -> int:
        """Segments (speculative rounds) run as graph replays."""
        return self._graphs.replays if self._graphs is not None else 0

    def _harvest(self, host, avail) -> None:
        """Append up to ``avail[slot]`` tokens per occupied row (capped by
        its budget); retire on eos or budget."""
        for slot, r in enumerate(self._slots):
            if r is None:
                continue
            take = min(int(avail[slot]), r["max_new"] - r["gen"])
            done = False
            for j in range(take):
                tok = int(host[slot][j])
                r["known"].append(tok)
                r["gen"] += 1
                if self.eos_id is not None and tok == self.eos_id:
                    done = True
                    break
            if done or r["gen"] >= r["max_new"]:
                self._results[r["id"]] = r["known"]
                self._slots[slot] = None
                if self._obs is not None:
                    self._obs.event("req_finish", rid=r["id"], gen=r["gen"],
                                    reason="eos" if done else "budget")

    def _spec_rounds(self, occ) -> int:
        """The boundary's round count: capped by the configured count, the
        max_len frontier (a round advances a clock by at most k+1) and the
        largest budget."""
        frontier = min((self._max_len - (len(r["known"]) - 1)) // (self.spec_k + 1)
                       for r in occ)
        need = max(r["max_new"] - r["gen"] for r in occ)
        return max(1, min(self.spec_rounds, frontier, need))

    def _spec_step(self, occ) -> None:
        """One speculative scheduling round: ``rounds`` draft-verify
        rounds over the batch, then retirement on the per-row harvest."""
        k, nb, dev = self.spec_k, self._nb, self.device
        rounds = self._spec_rounds(occ)
        if self._spec is None:
            self._spec = (torch.zeros(nb, self.spec_rounds * (k + 1), dtype=torch.long,
                                      device=dev),
                          torch.zeros(nb, dtype=torch.long, device=dev),
                          torch.zeros(nb, dtype=torch.long, device=dev),
                          torch.ones(nb, dtype=torch.bool, device=dev))
        out, n, pos, active = self._spec
        t_seg = time.perf_counter() if self._obs is not None else 0.0
        pos.copy_(torch.tensor([0 if r is None else len(r["known"]) - 1
                                for r in self._slots], dtype=torch.long))
        out.zero_()
        n.zero_()
        for _ in range(rounds):
            self._run("spec-round", list(self._spec), lambda: _serve_spec_round(
                self._dec, self._dft, k, self.params, self._d_params, self._cache,
                self._d_cache, self._prev, pos, active, out, n))
        self.segments_run += 1
        self._harvest(out.cpu().tolist(), n.cpu().tolist())
        if self._obs is not None:
            self._segment_event(t_seg, rounds, len(occ), spec=True)

    def _segment_event(self, t_begin, seg, occupied, spec=False) -> None:
        """One ``segment`` record per boundary: duration (segment and
        fetch), occupancy entering it, and the queue depth left waiting."""
        self._obs.event(
            "segment", seg=int(seg), occupied=occupied,
            nslots=min(self._nb, self.max_batch),
            waiting=len(self._waiting),
            dur=time.perf_counter() - t_begin,
            **({"spec": True} if spec else {}),
        )

    def obs_event(self, ev: str, **fields) -> None:
        """Journal a caller-side event (the load harness's chaos faults);
        a no-op when obs is off."""
        if self._obs is not None:
            self._obs.event(ev, **fields)

    @property
    def obs_registry(self):
        """The live metrics registry when ``ObsConfig.live`` is armed,
        else None (the ``obs.live.live_registry`` hook)."""
        return self._obs.registry if self._obs is not None else None

    def close(self) -> None:
        """Flush and close the obs journal (idempotent)."""
        if self._obs is not None:
            self._obs.close()

    def _stream_slice(self, r: dict, steps: int):
        """Keys ``[gen, gen + steps)`` of the request's stream, padded by
        repeating the last key (pad keys feed only discarded ticks)."""
        s = r["stream"][r["gen"]: r["gen"] + steps]
        if s.shape[0] < steps:
            s = torch.cat([s, s[-1:].expand(steps - s.shape[0], 2)])
        return s

    def drain(self) -> dict:
        """Run until every submitted request finished; returns {id:
        tokens} (prompt included, truncated just past eos). Raises on a
        poisoned server; use :meth:`results` for the completed work."""
        self._check_poisoned()
        while self._waiting or self._occupied():
            self.step()
        return self.results()


def _rnn_prefill_rows(model, pre_bucket, greedy, top_k, use_top_p, params,
                      cache0, pre_buf, p_lens, keys0, temp, top_p):
    """RNN admission: the group through ``rnn_sampling._rnn_prefill`` (each
    row's carries freeze at its own length) and each row's first token."""
    from mpit_tpu_torch.models.rnn_sampling import _rnn_prefill

    cache, last = _rnn_prefill(model, params, cache0, pre_buf, p_lens)
    tok0 = sampling._sample_rows(last, keys0, greedy, top_k, use_top_p, temp,
                                 top_p)
    return cache, tok0


def _rnn_prefill_template(model, pre_bucket, params, cache0, pre_buf, p_len):
    """Carry-only RNN prefill for the prefix template."""
    from mpit_tpu_torch.models.rnn_sampling import _rnn_prefill

    cache, _ = _rnn_prefill(model, params, cache0, pre_buf, p_len,
                            with_head=False)
    return cache


class RNNServer(Server):
    """Continuous batching for the carry-decode LSTM family: the same
    scheduler, with the carry tree in place of the K/V cache, admission
    through the ``seq_lengths`` prefill, and no ``max_len`` horizon.
    Speculative mode is refused. Every result equals its solo
    :func:`~mpit_tpu_torch.models.rnn_sampling.generate_rnn` call."""

    def __init__(self, model, params, **kw):
        if getattr(model, "max_len", None) is not None:
            raise ValueError(
                "RNNServer serves carry-decode RNN models (no max_len "
                "horizon); use Server for KV-cache transformer models"
            )
        super().__init__(model, params, **kw)

    def _prefill_call(self, pre_bucket, cache0, pre_buf, p_lens, keys0, temps,
                      tops, pfx):
        del pfx  # carries have no clock to offset
        return _rnn_prefill_rows(
            self._dec, pre_bucket, self._greedy, self.top_k,
            self.top_p is not None, self.params, cache0, pre_buf, p_lens,
            keys0, temps, tops,
        )

    def _template_call(self, pb, buf, p_len):
        return _rnn_prefill_template(
            self._dec, pb, self.params,
            self._dec.init_cache(1, self.device), buf, p_len,
        )
