"""Shared role bodies for the host-async PS protocol.

Counterpart of ``mpit_tpu/parallel/ps_roles.py``: the client training loop
of thread mode (:class:`mpit_tpu_torch.parallel.ps_trainer.AsyncPSTrainer`,
clients as threads over the in-process broker). The reference runs the same
body in process mode too (``examples/ptest_proc.py`` under
``mpit_tpu.launch``); that runtime comes with ROADMAP.md item A7c.

A client's τ local steps run on its device, its exchange on the host in
numpy, as in the reference: the flat vector is fetched to the host at each
τ boundary, pushed, moved elastically toward the fetched center and sent
back to the device.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from mpit_tpu_torch.obs.core import span as obs_span
from mpit_tpu_torch.obs.live import (
    M_COMPUTE_S,
    M_ELASTIC_DIST,
    M_EXCHANGE_FAILURES,
    M_EXCHANGE_LAT,
    M_EXCHANGE_S,
    M_NORM_RATIO,
    M_PARAM_NORM,
    M_PUSHES,
    M_PUSH_NORM,
    M_REPAIRED_CHUNKS,
    M_ROUNDS,
    M_SAMPLES,
    M_SKIPPED_ROUNDS,
    M_STALE_PARAMS,
    M_STEPS,
    live_registry,
)
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.parallel.pclient import PClient
from mpit_tpu_torch.transport import RecvTimeout
from mpit_tpu_torch.utils.params import (
    FlatParamSpec,
    flatten_params,
    unflatten_params,
)
from mpit_tpu_torch.utils.profiling import force_completion

logger = logging.getLogger("mpit_tpu_torch.parallel.ps_roles")

# mpit-analysis: protocol-role[client->server]
# (shared client-role body; its transport traffic all flows through
# PClient, as in the reference)


def make_local_step(model, optimizer, loss_fn: Optional[Callable] = None):
    """``(params, opt_state, x, y) -> (params, opt_state, loss)`` — the
    client's on-device compute between exchanges: one gradient of the
    mean cross-entropy and one ``optimizer.update``. Built once and shared
    by every client thread, as the reference shares one jitted step.

    Safe from several threads at once, with no lock between them: the
    gradient is ``torch.autograd.grad`` over fresh leaf tensors (autograd
    runs backward passes from different threads independently), and the
    default loss runs its forward on a copy of ``model`` per thread, since
    ``Model.apply`` (``torch.func.functional_call``) swaps the module's
    parameters while it runs. A ``loss_fn(params, x, y)`` given by the
    caller must be thread-safe itself. The loss comes back as a detached
    device scalar."""
    if loss_fn is None:
        replicas = threading.local()

        def loss_fn(params, x, y):
            fn = getattr(replicas, "loss_fn", None)
            if fn is None:
                fn = replicas.loss_fn = common.default_loss_fn(
                    copy.deepcopy(model).apply
                )
            return fn(params, x, y)

    value_and_grad = common.autograd_value_and_grad(loss_fn)

    def local_step(params, opt_state, x, y):
        grads, loss = value_and_grad(params, x, y)
        params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    return local_step


def _to_device(flat: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a host f32 vector on ``device`` (never a view of
    ``flat``, which the wire contract forbids mutating)."""
    return torch.tensor(np.asarray(flat, np.float32), device=device)


def _record_dynamics(
    transport,
    reg,
    round_no: int,
    algo: str,
    flat: np.ndarray,
    center: np.ndarray,
    prev_center: Optional[np.ndarray],
    push_vec: Optional[np.ndarray] = None,
    alpha: Optional[float] = None,
) -> None:
    """Per-exchange training-dynamics record (docs/OBSERVABILITY.md
    "dynamics"): elastic distance ‖x_local − x̃‖ — THE quantity the EASGD
    analysis bounds — plus push-delta norm, fetch-delta norm (how far
    the center moved since this client's previous pull), param norm, and
    the update/param norm ratio.

    Every input is host numpy the exchange already materialized, so this
    adds no device sync. The caller invokes it only when the transport is
    obs-wrapped, which no transport of the port is until ROADMAP.md item
    A12: the obs-off cost is one attribute check per round.

    ``push_vec`` (downpour) is the pushed delta; for EASGD the push is
    the elastic move itself, so ``alpha`` is passed instead and
    push_norm = alpha·elastic without forming another vector.
    """
    elastic = float(np.linalg.norm(flat - center))
    push_norm = (
        float(np.linalg.norm(push_vec)) if push_vec is not None
        else float(alpha) * elastic
    )
    param_norm = float(np.linalg.norm(flat))
    fetch_delta = (
        0.0 if prev_center is None
        else float(np.linalg.norm(center - prev_center))
    )
    ratio = push_norm / param_norm if param_norm > 0.0 else 0.0
    tracer = getattr(transport, "obs_tracer", None)
    if tracer is not None and tracer.journal is not None:
        tracer.journal.event(
            "dynamics",
            tracer.clock.tick(),
            round=round_no,
            algo=algo,
            elastic=elastic,
            push_norm=push_norm,
            param_norm=param_norm,
            fetch_delta=fetch_delta,
            ratio=ratio,
        )
    reg.set_gauge(M_ELASTIC_DIST, elastic)
    reg.set_gauge(M_PUSH_NORM, push_norm)
    reg.set_gauge(M_PARAM_NORM, param_norm)
    reg.set_gauge(M_NORM_RATIO, ratio)


def client_train_loop(
    client: PClient,
    local_step,
    optimizer,
    spec: FlatParamSpec,
    x: torch.Tensor,
    y: torch.Tensor,
    steps: int,
    batch_size: int,
    tau: int,
    algo: str,
    alpha: float,
    seed: int,
    max_exchange_failures: Optional[int] = None,
    exchange_stats: Optional[dict] = None,
    join: bool = False,
) -> list[float]:
    """The pclient side of SURVEY.md §3(b): τ local steps on the device,
    then push/pull per ``algo`` ("easgd" or "downpour"). Returns per-step
    losses. Does NOT send stop — the caller owns teardown (it may want a
    final ``client.fetch()`` for evaluation first).

    ``x``/``y`` are this client's shard as tensors on its device, staged
    there once. Each step's minibatch is ``rng.integers(0, len(x),
    batch_size)`` from ``np.random.default_rng(seed)``, the reference's
    draw; all steps' indices are drawn up front in one call (numpy gives
    the same stream of numbers, which the parity tests hold) and cross to
    the device in one copy, so a step gathers its batch on the device and
    nothing crosses the bus per step.

    Graceful degradation (docs/ROBUSTNESS.md): with
    ``max_exchange_failures`` set, a failed exchange (timeout after the
    client's retries, or a transport error) logs, SKIPS the round — the
    client keeps training on its local params against the stale center —
    and only escalates once that many *consecutive* rounds have failed
    (any success resets the count). ``None`` keeps fail-fast semantics.
    ``exchange_stats`` (when provided) is filled with the reference's
    ``{"skipped_rounds", "exchange_failures", "repaired_chunks"}`` totals
    and with ``"rounds"`` and ``"exchange_s"``: the successful exchanges
    and their host seconds, which the reference publishes to its live
    registry (``M_ROUNDS``, ``M_EXCHANGE_S``) and the port's stand-in
    registry drops until ROADMAP.md item A12.

    ``join``: announce this client via the elastic-membership JOIN
    envelope for its initial pull instead of a plain fetch — required
    for elastic runs. Off by default: non-elastic runs keep their exact
    fetch counts.

    Loss scalars stay ON DEVICE between exchanges and are fetched in one
    batched transfer at each τ boundary, where the param flatten already
    waits for the device.

    Roofline instrumentation (docs/OBSERVABILITY.md): each τ-block of
    local steps runs inside a ``"compute"`` span that ends with
    :func:`force_completion` when the span is live (``ctx is not None``);
    with obs off (always, until A12) the loop keeps the free-running
    dispatch unchanged.
    """
    device = x.device
    rng = np.random.default_rng(seed)
    batch_idx = torch.as_tensor(
        rng.integers(0, len(x), (steps, batch_size))
    ).to(device)
    # live-metrics hook: the no-op registry until A12; publishes below are
    # unconditional, the disabled path is a no-op method call per round
    reg = live_registry(client.transport)
    with obs_span(client.transport, "initial_fetch"):
        # startup patience: the initial pull races server startup. A
        # client that comes up before its servers must wait, not die —
        # unlike mid-run failures, there is no stale center to fall back
        # on yet, so keep re-asking until the deadline
        deadline = time.monotonic() + 60.0
        while True:
            try:
                initial = client.join() if join else client.fetch()
                break
            except (RecvTimeout, ConnectionError, OSError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)
        params = unflatten_params(spec, _to_device(initial, device))
    opt_state = optimizer.init(params)
    last_pull = initial
    # training-dynamics plane: armed iff the transport is obs-wrapped —
    # the same zero-cost-when-off contract as the spans above. prev_center
    # remembers the previously fetched center for the fetch-delta norm.
    dyn_on = getattr(client.transport, "obs_tracer", None) is not None
    prev_center: Optional[np.ndarray] = None
    losses: list[float] = []
    pending: list = []
    consecutive_failures = 0
    skipped_rounds = 0
    total_failures = 0
    rounds = 0
    exchange_s = 0.0

    def flush():
        if pending:
            losses.extend(torch.stack(pending).cpu().tolist())
            pending.clear()

    done = 0
    round_no = 0
    while done < steps:
        k = min(tau, steps - done)
        t_c = time.perf_counter()
        with obs_span(
            client.transport, "compute", round=round_no + 1, steps=k
        ) as cspan:
            for i in range(done, done + k):
                idx = batch_idx[i]
                params, opt_state, loss = local_step(
                    params, opt_state, x[idx], y[idx]
                )
                pending.append(loss)
            if cspan is not None:
                # span live → pay the sync so compute time is real
                force_completion(params, loss)
        reg.inc(M_STEPS, k)
        reg.inc(M_SAMPLES, k * batch_size)
        reg.inc(M_COMPUTE_S, time.perf_counter() - t_c)
        done += k
        if k < tau:
            break  # steps % tau remainder trains without an exchange
        round_no += 1
        flush()
        # the broker hands `flat`'s slices to the server by reference, so
        # the loop below must never mutate `flat` in place; the
        # post-exchange elastic move builds a NEW array
        flat = flatten_params(params)[0].cpu().numpy()
        t_x = time.perf_counter()
        with obs_span(
            client.transport, "exchange",
            round=round_no, algo=algo,
        ):
            try:
                if algo == "easgd":
                    # fetch BEFORE push so the client's elastic move uses
                    # the pre-push center — the paper's update order (both
                    # moves on the old center), and the same order
                    # goptim.easgd_round implements for the collective
                    # path. The local params ride along as the repair
                    # fallback (ring mode).
                    center = client.fetch(fallback=flat)
                    client.push_easgd(flat)
                    if dyn_on:
                        _record_dynamics(
                            client.transport, reg, round_no, algo,
                            flat, center, prev_center, alpha=alpha,
                        )
                        prev_center = center
                    flat = flat - alpha * (flat - center)
                else:
                    delta = flat - last_pull
                    client.push_delta(delta)
                    # the pushed delta now belongs to the server: a fetch
                    # failure below must not get it re-pushed next round
                    prev_pull = last_pull
                    last_pull = flat
                    fetched = client.fetch(fallback=flat)
                    if dyn_on:
                        # elastic here = ‖local − fetched center‖; the
                        # fetch-delta baseline is the previous pull
                        _record_dynamics(
                            client.transport, reg, round_no, algo,
                            flat, fetched, prev_pull, push_vec=delta,
                        )
                    flat = fetched
                    last_pull = flat
            except (RecvTimeout, ConnectionError, OSError) as e:
                total_failures += 1
                consecutive_failures += 1
                reg.inc(M_EXCHANGE_FAILURES)
                if max_exchange_failures is None:
                    raise  # fail-fast semantics (degradation not enabled)
                if consecutive_failures >= max_exchange_failures:
                    raise RuntimeError(
                        f"PS exchange failed {consecutive_failures} "
                        "rounds in a row — escalating instead of "
                        "training further against an unreachable center"
                    ) from e
                skipped_rounds += 1
                reg.inc(M_SKIPPED_ROUNDS)
                reg.inc(M_EXCHANGE_S, time.perf_counter() - t_x)
                logger.warning(
                    "PS exchange failed (%r); skipping round on the "
                    "stale center (%d consecutive failure(s))",
                    e,
                    consecutive_failures,
                )
                continue  # params stay local this round
            consecutive_failures = 0
            dt_x = time.perf_counter() - t_x
            rounds += 1
            exchange_s += dt_x
            reg.inc(M_ROUNDS)
            reg.inc(M_EXCHANGE_S, dt_x)
            reg.observe(M_EXCHANGE_LAT, dt_x)
            reg.set_gauge(M_PUSHES, sum(client.push_sent.values()))
            reg.set_gauge(M_STALE_PARAMS, client.stale_params_dropped)
            reg.set_gauge(
                M_REPAIRED_CHUNKS, getattr(client, "repaired_chunks", 0)
            )
            params = unflatten_params(spec, _to_device(flat, device))
    flush()  # flush any remainder losses
    if exchange_stats is not None:
        exchange_stats["skipped_rounds"] = skipped_rounds
        exchange_stats["exchange_failures"] = total_failures
        exchange_stats["repaired_chunks"] = getattr(
            client, "repaired_chunks", 0
        )
        exchange_stats["rounds"] = rounds
        exchange_stats["exchange_s"] = exchange_s
    return losses
