"""Host-async parameter-server trainer: genuine protocol asynchrony.

Counterpart of ``mpit_tpu/parallel/ps_trainer.py``, thread mode: the
servers and the clients are threads of this process, exchanging tagged
messages over the in-process :class:`~mpit_tpu_torch.transport.Broker`
with real interleaving and unbounded staleness (BASELINE.json:7's
"2 pclient + 1 pserver" shape). The servers' centers and the elastic
moves are host numpy, as in the reference. Each client runs its τ local
steps on the device, on a CUDA stream of its own, through one local-step
function shared by all clients; the reference's compiled XLA step
releases the GIL while it runs, while here the clients' eager dispatch
shares it.

The message plane is the reference's: ``transport="auto"`` takes the C++
broker (:mod:`mpit_tpu_torch.native`) wherever it builds and the Python
one otherwise, ``"native"`` insists on the C++ one, ``"inproc"`` takes the
Python one, and ``"socket"`` gives every rank a real TCP
:class:`~mpit_tpu_torch.transport.SocketTransport` on loopback. Chaos
fault injection (the ``chaos`` argument or ``MPIT_CHAOS_*`` knobs) wraps
whichever was chosen, and the obs plane (the ``obs`` argument or
``MPIT_OBS_*`` knobs) wraps outermost, over chaos, as in the reference:
journals, live snapshots, the black box and the faulthandler.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Optional

import numpy as np
import torch

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.data.datasets import shard_for_worker
from mpit_tpu_torch.obs.core import (
    ObsConfig,
    arm_faulthandler,
    disarm_faulthandler,
    write_fault_log,
)
from mpit_tpu_torch.obs.core import config_from_env as obs_config_from_env
from mpit_tpu_torch.obs.telemetry import wrap_obs_transports
from mpit_tpu_torch.parallel import ps_roles
from mpit_tpu_torch.parallel.pclient import PClient
from mpit_tpu_torch.parallel.pserver import (
    PServer,
    partition_bounds,
    spawn_server_thread,
)
from mpit_tpu_torch.transport import Broker
from mpit_tpu_torch.transport.chaos import (
    ChaosConfig,
    FaultLog,
    config_from_env,
    wrap_transports,
)
from mpit_tpu_torch.utils.params import flatten_params, tree_map, unflatten_params


def _chaos_counts(fault_log: FaultLog, rank: int) -> Callable[[], dict]:
    """Live-snapshot collector: this rank's injected-fault counts by kind
    (faults are attributed to the rank whose send the injector hit)."""

    def counts() -> dict:
        out: dict = {}
        for e in fault_log.events():
            if e.src == rank:
                out[e.kind] = out.get(e.kind, 0) + 1
        return out

    return counts


class AsyncPSTrainer:
    """2-pclient+1-pserver-style async training (counts configurable).

    Transport ranks: ``[0, num_servers)`` are pservers, the rest pclients.
    The arguments and their checks are the reference's; ``device`` is the
    port's: where the clients' local steps run, the card unless it names
    the CPU.

    Args:
      algo: "easgd" (push params, elastic moves on both sides) or
        "downpour" (push accumulated delta, pull-replace).
      alpha: elastic coupling (both server- and client-side move).
      tau: local steps between exchanges.
      transport: "auto" (the C++ broker where it builds, else the Python
        one), "native" (the C++ broker; raises where it cannot build),
        "inproc" (the Python broker) or "socket" (TCP on loopback, one
        listener per rank).
      ckpt_dir: each server persists its center chunk to
        ``ckpt_dir/center_<rank>.npy`` every ``ckpt_every`` updates and at
        teardown; with ``resume`` (the default) a fresh ``train()`` whose
        servers find matching chunks restores the center. ``resume=
        False`` deletes stale chunks first (a deliberate fresh start).
      chaos: a :class:`~mpit_tpu_torch.transport.ChaosConfig` wrapping
        every rank's transport in the seeded fault injector; None reads
        the ``MPIT_CHAOS_*`` knobs (no knob, no chaos). The fault log of
        the last ``train()`` is ``self.fault_log``.
      obs: an :class:`~mpit_tpu_torch.obs.core.ObsConfig`; None reads the
        ``MPIT_OBS_*`` knobs (no knob, no wrapper at all). Armed, every
        transport is wrapped in a
        :class:`~mpit_tpu_torch.obs.telemetry.TelemetryTransport`
        outermost, over chaos, so the per-stream index stays in step with
        the fault schedule's: per-(peer, tag) counters land in
        ``stats["telemetry"]``, per-rank journals under ``obs.dir`` feed
        ``python -m mpit_tpu_torch.obs``, and with chaos the fault log is
        written beside them as ``faults.jsonl``.
      max_exchange_failures: graceful degradation — a client's failed
        exchange (after PClient's own retries) skips the round on the
        stale center; this many CONSECUTIVE failures escalate to an
        error. ``None`` = fail on the first exchange error.
      fetch_timeout / fetch_retries: forwarded to each PClient — the
        per-attempt PARAM wait and the retry budget for FETCH/PARAM
        and push sends.
      ps_shards: split the flat vector into this many shards placed on
        the servers by the consistent-hash ring (``MPIT_PS_SHARDS`` when
        None); None keeps one contiguous chunk per server.
    """

    def __init__(
        self,
        model,
        optimizer,
        num_clients: int = 2,
        num_servers: int = 1,
        algo: str = "easgd",
        alpha: float = 0.5,
        tau: int = 4,
        server_lr: float = 1.0,
        loss_fn: Optional[Callable] = None,
        transport: str = "auto",
        client_timeout: Optional[float] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_every: Optional[int] = 100,
        resume: bool = True,
        chaos: Optional[ChaosConfig] = None,
        obs: Optional[ObsConfig] = None,
        max_exchange_failures: Optional[int] = 3,
        fetch_timeout: float = 60.0,
        fetch_retries: int = 3,
        ps_shards: Optional[int] = None,
        device=None,
    ):
        if algo not in ("easgd", "downpour"):
            raise ValueError(f"unknown algo {algo!r}")
        if transport not in ("auto", "native", "inproc", "socket"):
            raise ValueError(f"unknown transport {transport!r}")
        self.transport_kind = transport
        # what the last train() ran on: "native", "inproc" or "socket"
        self.transport_used: Optional[str] = None
        self.chaos = chaos
        self.obs = obs
        # failure detection (SURVEY.md §5 do-better): silence beyond this →
        # the client is declared dead instead of hanging the job forever
        if client_timeout is not None and client_timeout <= 0:
            raise ValueError(
                "client_timeout must be positive (use None to disable)"
            )
        self.client_timeout = client_timeout
        if num_clients < 1 or num_servers < 1:
            raise ValueError("need at least one client and one server")
        self.model = model
        self.optimizer = optimizer
        self.num_clients = num_clients
        self.num_servers = num_servers
        self.algo = algo
        self.alpha = float(alpha)
        self.tau = int(tau)
        self.server_lr = float(server_lr)
        if ckpt_every is not None and ckpt_every < 1:
            raise ValueError(
                "ckpt_every must be >= 1 (None = persist only at teardown)"
            )
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = None if ckpt_every is None else int(ckpt_every)
        self.resume = bool(resume)
        if max_exchange_failures is not None and max_exchange_failures < 1:
            raise ValueError(
                "max_exchange_failures must be >= 1 (None = fail fast)"
            )
        if fetch_timeout <= 0:
            raise ValueError("fetch_timeout must be positive")
        if fetch_retries < 0:
            raise ValueError("fetch_retries must be >= 0")
        if ps_shards is None:
            env_shards = int(os.environ.get("MPIT_PS_SHARDS", "0"))
            ps_shards = env_shards if env_shards > 0 else None
        if ps_shards is not None and ps_shards < 1:
            raise ValueError("ps_shards must be >= 1 (None = legacy layout)")
        self.ps_shards = ps_shards
        self.max_exchange_failures = max_exchange_failures
        self.fetch_timeout = float(fetch_timeout)
        self.fetch_retries = int(fetch_retries)
        self.device = resolve_device(device)
        # per-client exchange accounting of the last train(): the
        # reference's skipped/failed/repaired counts plus rounds and
        # exchange seconds (ps_roles.client_train_loop)
        self.exchange_stats: list[dict] = []
        self.fault_log: Optional[FaultLog] = None
        # one local step shared by all client threads
        self._local_step = ps_roles.make_local_step(model, optimizer, loss_fn)

    def _make_broker(self, size: int):
        if self.transport_kind in ("auto", "native"):
            from mpit_tpu_torch import native

            if native.is_available():
                self.transport_used = "native"
                return native.NativeBroker(size)
            if self.transport_kind == "native":
                # surface WHY it is unavailable (an explicit request must
                # never silently get the Python broker)
                native.ensure_built()
                self.transport_used = "native"
                return native.NativeBroker(size)
        self.transport_used = "inproc"
        return Broker(size)

    def _make_transports(self, size: int) -> list:
        if self.transport_kind != "socket":
            return self._make_broker(size).transports()
        # real-TCP loopback world: reserve one ephemeral port per rank
        # (bind 0, read, release), then hand every rank the full address
        # table. The release→bind window is racy in principle; in practice
        # the kernel avoids handing a just-released ephemeral port straight
        # back out, and a lost race fails loudly at bind.
        import socket as _socket

        from mpit_tpu_torch.transport.socket_transport import SocketTransport

        probes = []
        addrs: list[tuple[str, int]] = []
        for _ in range(size):
            s = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            addrs.append(("127.0.0.1", s.getsockname()[1]))
            probes.append(s)
        for s in probes:
            s.close()
        self.transport_used = "socket"
        return [
            SocketTransport(r, size, addresses=addrs) for r in range(size)
        ]

    def train(
        self,
        x,
        y,
        steps: int,
        batch_size: int = 64,
        init_rng: Optional[torch.Generator] = None,
        seed: int = 0,
        init_params=None,
    ):
        """Run the async job; returns (center_params, stats).

        Each client trains on its own contiguous data shard (per-rank split,
        as the reference sharded MNIST by worker id) for ``steps`` local
        steps, exchanging with the servers every ``tau`` steps. ``x``/``y``
        are numpy arrays or tensors; they are staged on the device once,
        and a caller that stages them itself (as ``run()`` does, before
        its clock) passes device tensors. The center starts from
        ``init_params`` when given (a port tree, e.g. ``convert.from_flax``
        of the reference's init), else from ``model.init(init_rng)``,
        ``init_rng`` defaulting to a generator seeded with ``seed``.
        """
        if init_params is None:
            gen = (
                init_rng if init_rng is not None
                else torch.Generator().manual_seed(seed)
            )
            init_params = self.model.init(gen)
        params0 = tree_map(lambda a: a.detach().to(self.device), init_params)
        flat0_t, spec = flatten_params(params0)
        flat0 = flat0_t.cpu().numpy().astype(np.float32, copy=True)
        x = torch.as_tensor(x).to(self.device)
        y = torch.as_tensor(y).to(self.device)

        raw_transports = self._make_transports(
            self.num_servers + self.num_clients
        )
        transports = raw_transports
        # fault injection: explicit config wins, env knobs activate it for
        # launcher-driven runs (MPIT_CHAOS_*; see launch.py's diagnostic)
        chaos_cfg = self.chaos if self.chaos is not None else config_from_env()
        self.fault_log = None
        if chaos_cfg is not None:
            transports, self.fault_log = wrap_transports(transports, chaos_cfg)
        # observability wraps OUTERMOST over chaos: counters see every
        # attempted send (faults included), latency includes injected
        # delay, and the per-(dst, tag) stream index stays in lockstep
        # with the chaos schedule's — the merger's fault-placement key
        obs_cfg = self.obs if self.obs is not None else obs_config_from_env()
        obs_transports: list = []
        if obs_cfg is not None:
            # hung-job forensics (MPIT_OBS_FAULTHANDLER): periodic all-thread
            # stack dumps while the job runs, cancelled at clean teardown
            arm_faulthandler(obs_cfg, "trainer")
            transports = wrap_obs_transports(transports, obs_cfg)
            obs_transports = transports
            if obs_cfg.live and self.fault_log is not None:
                # per-rank chaos fault counts ride the live snapshots: a
                # pull collector sampled at export time
                for t in obs_transports:
                    t.obs_registry.add_collector(
                        "chaos", _chaos_counts(self.fault_log, t.rank)
                    )
        server_ranks = list(range(self.num_servers))
        client_ranks = list(
            range(self.num_servers, self.num_servers + self.num_clients)
        )
        bounds = partition_bounds(flat0.size, self.num_servers)
        shard_map = None
        if self.ps_shards is not None:
            from mpit_tpu_torch.comm.topology import HashRing, ShardMap

            # ring placement: every actor derives the same shard→server
            # assignment from the member list alone (blake2b, not Python
            # hash()), so no coordinator hands out the layout
            shard_map = ShardMap(
                HashRing(server_ranks), flat0.size, self.ps_shards
            )

        ckpt_paths = [None] * self.num_servers
        if self.ckpt_dir is not None:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            ckpt_paths = [
                os.path.join(self.ckpt_dir, f"center_{r}.npy")
                for r in server_ranks
            ]
            if not self.resume:  # deliberate fresh start: drop stale chunks
                for p in ckpt_paths:
                    if os.path.exists(p):
                        os.remove(p)

        def _server_center(r: int, start: int, end: int) -> np.ndarray:
            if shard_map is None:
                return flat0[start:end]
            # sharded: this server's center is the ascending concat of the
            # shards the ring assigns it (possibly non-contiguous in the
            # flat vector, possibly empty when servers outnumber shards)
            pieces = [flat0[s:e] for _, s, e in shard_map.ranges_for(r)]
            if not pieces:
                return np.zeros(0, np.float32)
            return np.concatenate(pieces)

        servers = [
            PServer(
                transports[r],
                _server_center(r, start, end),
                num_clients=self.num_clients,
                alpha=self.alpha,
                server_lr=self.server_lr,
                client_ranks=client_ranks,
                client_timeout=self.client_timeout,
                ckpt_path=path,
                ckpt_every=self.ckpt_every,
                shard_map=shard_map,
            )
            for r, (start, end), path in zip(server_ranks, bounds, ckpt_paths)
        ]

        losses = [[] for _ in range(self.num_clients)]
        errors: list[BaseException] = []
        clients: list = [None] * self.num_clients
        exchange_stats: list[dict] = [{} for _ in range(self.num_clients)]
        # one CUDA stream per client (the current stream is per thread),
        # ordered after whatever the caller queued on this thread's stream
        streams = [None] * self.num_clients
        if self.device.type == "cuda":
            for c in range(self.num_clients):
                streams[c] = torch.cuda.Stream(self.device)
                streams[c].wait_stream(torch.cuda.current_stream(self.device))

        def client_main(c: int):
            client = None
            stream = streams[c]
            try:
                tp = transports[self.num_servers + c]
                hb = (
                    self.client_timeout / 3
                    if self.client_timeout is not None
                    else None
                )
                client = PClient(
                    tp, server_ranks, flat0.size, heartbeat_interval=hb,
                    timeout=self.fetch_timeout,
                    max_retries=self.fetch_retries,
                    shard_map=shard_map,
                )
                clients[c] = client
                xs = shard_for_worker(x, c, self.num_clients)
                ys = shard_for_worker(y, c, self.num_clients)
                ctx = (
                    torch.cuda.stream(stream) if stream is not None
                    else contextlib.nullcontext()
                )
                with ctx:
                    losses[c] = ps_roles.client_train_loop(
                        client, self._local_step, self.optimizer, spec,
                        xs, ys, steps, batch_size, self.tau, self.algo,
                        self.alpha, seed=seed + 1000 + c,
                        max_exchange_failures=self.max_exchange_failures,
                        exchange_stats=exchange_stats[c],
                    )
                client.stop()
            except BaseException as e:  # surface thread failures to caller
                errors.append(e)
                try:
                    if client is not None:
                        # stops the heartbeat thread AND detaches — a leaked
                        # heartbeat would flood the brokers forever
                        client.stop()
                    else:
                        PClient(
                            transports[self.num_servers + c],
                            server_ranks,
                            flat0.size,
                        ).stop()
                except Exception:
                    pass
            finally:
                if stream is not None:
                    # nothing of this client may still run when train()
                    # returns and the caller frees the staged data
                    stream.synchronize()

        server_threads = [spawn_server_thread(s) for s in servers]
        client_threads = [
            threading.Thread(target=client_main, args=(c,), daemon=True)
            for c in range(self.num_clients)
        ]

        def teardown_transports():
            # socket mode owns real OS resources (listeners, connections,
            # sender threads) — close them; broker modes die with the run
            if self.transport_kind == "socket":
                for t in raw_transports:
                    try:
                        t.close()
                    except OSError:
                        pass

        for t in client_threads:
            t.start()
        for t in client_threads:
            t.join()
        for t in server_threads:
            t.join(timeout=30)
        self.exchange_stats = exchange_stats
        server_errors = [s.error for s in servers if s.error is not None]
        if server_errors:
            teardown_transports()
            raise RuntimeError("pserver died during training") from server_errors[0]
        if errors:
            teardown_transports()
            raise errors[0]

        if shard_map is None:
            center_flat = np.concatenate([s.snapshot() for s in servers])
        else:
            # place each server's owned shards back by the STATIC layout
            # (ownership may have moved mid-run; seed values back any shard
            # nobody ended up holding)
            center_flat = np.array(flat0, copy=True)
            for s in servers:
                snap = s.snapshot()
                off = 0
                for _sid, start, end in s.owned_ranges():
                    n = end - start
                    center_flat[start:end] = snap[off:off + n]
                    off += n
        center_params = unflatten_params(
            spec, torch.tensor(center_flat, device=self.device)
        )
        stats = {
            "server_counts": [dict(s.counts) for s in servers],
            # True iff every server restored a persisted center chunk —
            # the elastic-recovery signal a resumed job asserts on
            "center_restored": all(s.restored for s in servers),
            # reported as client INDICES (0..num_clients), consistent with
            # "losses" and data sharding — not raw transport ranks
            "dead_clients": sorted(
                r - self.num_servers
                for r in set().union(*(s.dead_clients for s in servers))
            ),
            "mean_final_loss": float(
                np.mean([l[-1] for l in losses if l]) if any(losses) else np.nan
            ),
            "losses": losses,
            # robustness accounting (docs/ROBUSTNESS.md): per-client push
            # sends that reached the transport (== what servers should
            # have applied under dedup), rounds degraded, stale PARAM
            # replies the attempt-id check discarded
            "push_sent": [
                dict(c.push_sent) if c is not None else {} for c in clients
            ],
            "stale_params_dropped": [
                c.stale_params_dropped if c is not None else 0
                for c in clients
            ],
            "skipped_rounds": [
                s.get("skipped_rounds", 0) for s in exchange_stats
            ],
            "ps_shards": self.ps_shards,
            "repaired_chunks": [
                s.get("repaired_chunks", 0) for s in exchange_stats
            ],
            "exchange_failures": [
                s.get("exchange_failures", 0) for s in exchange_stats
            ],
            # dynamics plane: per-server center version reached, and
            # per-source push-staleness tallies
            "server_versions": [s.version for s in servers],
            "staleness_by_src": [
                {src: dict(st) for src, st in sorted(
                    s.staleness_by_src.items())}
                for s in servers
            ],
        }
        if self.fault_log is not None:
            stats["chaos_faults"] = self.fault_log.counts()
        if obs_transports:
            stats["telemetry"] = [t.summary() for t in obs_transports]
            if obs_cfg.dir is not None and self.fault_log is not None:
                write_fault_log(
                    self.fault_log.events(),
                    os.path.join(obs_cfg.dir, "faults.jsonl"),
                )
            for t in obs_transports:
                # flush/close journals now — the broker dies with this
                # call, and a merge may run immediately after train()
                t.obs_tracer.close()
                # stop live exporters too (final snapshot hits disk)
                t.close_live()
            if obs_cfg.faulthandler > 0:
                disarm_faulthandler()
        # exact socket-level byte totals (socket mode only)
        if self.transport_kind == "socket":
            stats["wire_bytes"] = [
                t.wire_byte_counts() for t in raw_transports
            ]
        teardown_transports()
        return center_params, stats

    @torch.no_grad()
    def evaluate(self, params, x, y, batch: int = 512) -> float:
        """Accuracy of ``params`` over the same whole batches the
        reference counts."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        n = (len(x) // batch) * batch or len(x)
        for i in range(0, n, batch):
            xb = torch.as_tensor(x[i : i + batch]).to(self.device)
            yb = torch.as_tensor(y[i : i + batch]).to(self.device)
            logits = self.model.apply(params, xb)
            correct += (logits.argmax(-1) == yb).sum()
        return int(correct) / n
