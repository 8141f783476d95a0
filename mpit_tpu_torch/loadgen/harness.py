"""In-process open-loop load harness for ``Server``/``RNNServer``.

Drives a scheduled workload (:func:`~mpit_tpu_torch.loadgen.workload.
make_workload`) against a live server on one thread: at every loop turn
it submits the arrivals that have come due, fires due cancellations,
optionally applies the boundary's chaos fault, and runs one scheduling
step. Open-loop means arrivals never wait for capacity — under overload
the server's queue grows and TTFT/e2e stretch, which is the measurement.

The per-request record is the SERVER's obs journal (construct the
server with ``obs=ObsConfig(dir=...)``); the harness adds only its
chaos faults (``serve_fault`` via ``Server.obs_event``) and returns a
client-side :class:`LoadReport`. One caveat the journal carries: the
loop is single-threaded, so an arrival due mid-segment is submitted at
the next boundary — ``max_submit_lateness_s`` bounds how much TTFT
undercounts that way (a segment's wall-clock at most; keep segments
small when measuring tight SLOs, docs/SERVING.md).
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Optional

from mpit_tpu_torch.loadgen.chaos import ServeChaos
from mpit_tpu_torch.loadgen.workload import Request
from mpit_tpu_torch.obs.live import (
    M_LOAD_LATENESS_S,
    M_LOAD_PENDING,
    live_registry,
)


@dataclasses.dataclass
class LoadReport:
    """Client-side outcome of one harness run. ``results`` maps rid →
    full token list (prompt included — the Server convention);
    ``requests`` maps rid back to its scheduled :class:`Request`."""

    results: dict
    requests: dict
    submitted: int
    cancelled: int
    killed: bool
    boundaries: int
    wall_s: float
    max_submit_lateness_s: float


class LoadHarness:
    """Run one workload against one server.

    ``chaos``: optional :class:`~mpit_tpu_torch.loadgen.chaos.ServeChaos`
    applied per boundary. ``idle_sleep``: poll granularity while waiting
    for the next arrival with an empty server (bounded busy-wait)."""

    def __init__(
        self,
        server,
        requests: list,
        chaos: Optional[ServeChaos] = None,
        idle_sleep: float = 0.001,
    ):
        self.server = server
        self.requests = sorted(requests, key=lambda r: r.arrival_s)
        self.chaos = chaos
        self.idle_sleep = idle_sleep

    def run(self) -> LoadReport:
        srv = self.server
        reqs = self.requests
        # harness-side live gauges through the server's registry (the
        # no-op NULL_REGISTRY unless ObsConfig.live armed the server):
        # the client's view — pending load and submit lateness — rides
        # the same snapshots the server's lifecycle counters do
        reg = live_registry(srv)
        t0 = time.perf_counter()
        i = 0
        cancels: list = []  # (due_s, rid) min-heap
        results: dict = {}
        by_rid: dict = {}
        cancelled = 0
        killed = False
        boundary = 0
        max_late = 0.0
        while True:
            now = time.perf_counter() - t0
            while i < len(reqs) and reqs[i].arrival_s <= now:
                r = reqs[i]
                r.rid = srv.submit(
                    list(r.prompt), r.max_new,
                    temperature=r.temperature, top_p=r.top_p,
                    slo_ms=r.slo_ms,
                )
                by_rid[r.rid] = r
                max_late = max(max_late, now - r.arrival_s)
                if r.cancel_after_s is not None:
                    heapq.heappush(
                        cancels, (now + r.cancel_after_s, r.rid)
                    )
                i += 1
            while cancels and cancels[0][0] <= now:
                _, rid = heapq.heappop(cancels)
                if srv.cancel(rid):  # False: already finished — keep it
                    cancelled += 1
            results.update(srv.results())
            if srv.pending == 0:
                if i >= len(reqs):
                    break
                gap = reqs[i].arrival_s - now
                if gap > 0:
                    time.sleep(min(self.idle_sleep, gap))
                continue
            if self.chaos is not None:
                fault = self.chaos.draw(boundary)
                if fault is not None:
                    kind, delay = fault
                    srv.obs_event(
                        "serve_fault", kind=kind, boundary=boundary,
                        **({"delay": round(delay, 6)} if delay else {}),
                    )
                    if kind == "kill":
                        killed = True
                        break
                    time.sleep(delay)
            srv.step()
            boundary += 1
            reg.set_gauge(M_LOAD_PENDING, srv.pending)
            reg.set_gauge(M_LOAD_LATENESS_S, max_late)
        results.update(srv.results())
        srv.close()
        return LoadReport(
            results=results,
            requests=by_rid,
            submitted=i,
            cancelled=cancelled,
            killed=killed,
            boundaries=boundary,
            wall_s=time.perf_counter() - t0,
            max_submit_lateness_s=max_late,
        )
