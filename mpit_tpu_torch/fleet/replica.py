# mpit-analysis: protocol-role[serving_replica->serving_router]
"""Serving replica: a ``Server`` behind a transport dispatch loop; the
port's counterpart of ``mpit_tpu/fleet/replica.py``.

One replica = one :class:`mpit_tpu_torch.models.serving.Server` owned by one
rank, serving ROUTE requests from the router and absorbing WEIGHT_PUSH
refreshes between scheduling steps. The loop is the pserver dispatch
idiom — a wildcard recv routed by tag comparison — so the protocol-role
model extracts its alphabet and MPT008 pairs it against the router's.

Wire tags 11–15 extend the registry in ``parallel/pserver.py`` (1–10);
the fleet gets its own STOP tag rather than reusing ``TAG_STOP`` so the
wire-schema lock never unions two protocols' payload shapes under one
tag. Payload envelopes (all framed — tuples of scalars, lists and
arrays; MPT017 keeps them off the pickle fallback):

- ``ROUTE``  (router→replica): ``(rid, prompt, max_new, slo_ms)``
- ``REPLY``  (replica→router): ``(rank, rid, tokens, version)`` —
  ``version`` is the replica's serving weights version, the audit stamp
- ``WEIGHT_SUB``  (replica→router): ``(rank, have_version)``
- ``WEIGHT_PUSH`` (router→replica): ``(version, names, arrays)``
- ``FLEET_STOP``  (router→replica): ``0``

Weight installs are **read-only** consumption of the PS fetch shapes:
quantized leaves (bf16/int8 ``QuantArray``) are dequantized on arrival
and swapped into the server between segments — no error feedback,
nothing flows back toward training.
"""

from __future__ import annotations

from mpit_tpu_torch.obs.live import M_FLEET_WEIGHTS_VERSION, live_registry
from mpit_tpu_torch.transport.base import RecvTimeout

# fleet wire tags — continuing the PS registry (parallel/pserver.py owns
# 1–10); the values are part of the wire-schema lock
TAG_ROUTE = 11
TAG_REPLY = 12
TAG_WEIGHT_SUB = 13
TAG_WEIGHT_PUSH = 14
TAG_FLEET_STOP = 15


class ReplicaServer:
    """Own one serving ``Server`` on one transport rank.

    ``transport``: any :class:`mpit_tpu_torch.transport.base.Transport` bound
    to this replica's rank. ``router_rank``: where replies and weight
    subscriptions go. ``serve_every``: scheduling steps run per loop
    turn once work is queued (1 = finest-grained weight-refresh
    interleaving)."""

    def __init__(
        self,
        server,
        transport,
        router_rank: int = 0,
        serve_every: int = 1,
        poll_s: float = 0.02,
    ):
        if serve_every < 1:
            raise ValueError("serve_every must be >= 1")
        self.server = server
        self.transport = transport
        self.rank = transport.rank
        self.router_rank = int(router_rank)
        self.serve_every = int(serve_every)
        self.poll_s = float(poll_s)
        self.killed = False  # chaos hook: a set flag is a SIGKILL
        self.stopped = False
        self._inflight: dict[int, int] = {}  # server rid -> fleet rid
        self._replies = 0

    # -- weight refresh ----------------------------------------------------

    def subscribe_weights(self) -> None:
        """Tell the router's publisher what version this replica serves
        (0 = construction-time weights, never pushed); the publisher
        answers with a WEIGHT_PUSH iff it has something newer."""
        self.transport.send(
            self.router_rank,
            TAG_WEIGHT_SUB,
            (self.rank, int(self.server.weights_version)),
        )

    def _install(self, version: int, names, arrays) -> None:
        # local import: weights.py imports this module for the tag
        # registry; deferring the reverse edge keeps import acyclic
        from mpit_tpu_torch.fleet.weights import unflatten_like

        if int(version) <= self.server.weights_version:
            return  # duplicate/stale push — installs are idempotent
        params = unflatten_like(self.server.params, names, arrays)
        self.server.install_weights(params, version=version)
        live_registry(self.server).set_gauge(
            M_FLEET_WEIGHTS_VERSION, self.server.weights_version
        )

    # -- request lifecycle -------------------------------------------------

    def _admit(self, rid: int, prompt, max_new: int, slo_ms: float) -> None:
        srv_rid = self.server.submit(
            [int(t) for t in prompt],
            int(max_new),
            slo_ms=float(slo_ms) if slo_ms > 0 else None,
        )
        self._inflight[srv_rid] = rid

    def _flush_results(self) -> None:
        for srv_rid, tokens in self.server.results().items():
            rid = self._inflight.pop(srv_rid, None)
            if rid is None:
                continue
            if self.killed:
                # a killed replica's reply dies with it — the router's
                # detect-timeout + redispatch path owns this request now
                continue
            self.transport.send(
                self.router_rank,
                TAG_REPLY,
                (
                    self.rank,
                    rid,
                    [int(t) for t in tokens],
                    int(self.server.weights_version),
                ),
            )
            self._replies += 1

    # -- dispatch loop -----------------------------------------------------

    def run(self) -> dict:
        """Serve until FLEET_STOP (or a chaos kill). Returns a small
        summary for the harness/postmortem."""
        while not self.stopped and not self.killed:
            # drain everything queued before spending time on a segment
            try:
                timeout = 0.0 if self.server.pending else self.poll_s
                msg = self.transport.recv(timeout=timeout)
            except RecvTimeout:
                msg = None
            if self.killed:
                break
            if msg is not None:
                if msg.tag == TAG_ROUTE:
                    rid, prompt, max_new, slo_ms = msg.payload
                    self._admit(rid, prompt, max_new, slo_ms)
                elif msg.tag == TAG_WEIGHT_PUSH:
                    version, names, arrays = msg.payload
                    self._install(version, names, arrays)
                elif msg.tag == TAG_FLEET_STOP:
                    self.stopped = True
                continue
            if self.server.pending:
                for _ in range(self.serve_every):
                    if self.server.pending == 0 or self.killed:
                        break
                    self.server.step()
                self._flush_results()
        self._flush_results()
        return {
            "rank": self.rank,
            "replies": self._replies,
            "weights_version": int(self.server.weights_version),
            "killed": bool(self.killed),
            "abandoned": len(self._inflight),
        }

    def close(self) -> None:
        try:
            self.server.close()
        except Exception:
            pass
