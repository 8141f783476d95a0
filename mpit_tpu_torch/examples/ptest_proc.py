"""ptest_proc — the MNIST PS example in the reference's literal shape:
one OS process per rank, launched like mpirun (SURVEY.md §3(a)):

    python -m mpit_tpu_torch.launch -n 3 mpit_tpu_torch/examples/ptest_proc.py --preset mnist-ps

The counterpart of ``examples/ptest_proc.py``. Rank→role split happens
here, as the reference's ptest.lua did it from its MPI rank: ranks [0,
servers) are pservers, the rest pclients. Messages ride
:class:`mpit_tpu_torch.transport.SocketTransport` (TCP), addresses from
``MPIT_TRANSPORT_HOSTS`` (exported by the launcher; set it yourself across
real hosts). The frames are the reference's, so a rank of this script and
a rank of the reference's script can share one world. Every rank builds
identical params from the shared seed, the deterministic-init equivalent
of the reference's rank-0-construct + bcast.

A pserver holds host numpy only and never touches the card. A pclient
runs its local steps on ``--device`` (``cuda``, the default, or ``cpu``:
the counterpart of the ``JAX_PLATFORMS`` the reference's script reads) and
prints, beside the reference's lines, its training loop's samples, wall
seconds and exchange milliseconds per round (process start, CUDA set-up
and the servers' start-up excluded: one throwaway local step runs, and the
connections to the servers open, before the clock), and
client 0 the sha256 of the center it fetched last. The protocol body is
``ps_roles.client_train_loop``, the code thread mode runs.

``MPIT_CHAOS_*`` wraps each rank's socket in the fault injector;
``MPIT_ELASTIC_RESPAWN``, ``MPIT_ELASTIC_CKPT_DIR`` (a shard snapshot per
server), ``MPIT_PS_SHARDS``, ``MPIT_CONNECT_RETRY_S``, ``MPIT_PS_TIMEOUT``
and ``MPIT_PS_MAX_RETRIES`` act as in the reference. ``MPIT_OBS_*`` wraps
the socket (outermost, over chaos) for journals, live snapshots and the
black box, and with chaos each rank writes ``faults_rank<r>.jsonl`` beside
its journal; ``python -m mpit_tpu_torch.obs`` reads the directory. Armed,
each rank prints its telemetry summary (``rank <r>: telemetry {...}``) at
teardown, the socket's receive-side phase split among it.
"""

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)


def main():
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    known, rest = pre.parse_known_args()

    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig.from_args(rest, description=__doc__)

    try:
        rank = int(os.environ["MPIT_RANK"])
        world = int(os.environ["MPIT_WORLD_SIZE"])
    except KeyError:
        raise SystemExit(
            "MPIT_RANK/MPIT_WORLD_SIZE not set — run under `python -m "
            "mpit_tpu_torch.launch -n N mpit_tpu_torch/examples/ptest_proc.py ...`"
        )
    num_servers = cfg.servers
    num_clients = world - num_servers
    if num_clients < 1:
        raise SystemExit(
            f"world of {world} with {num_servers} servers leaves no clients"
        )
    alpha = cfg.alpha if cfg.alpha is not None else 0.9 / num_clients

    import numpy as np
    import torch

    from mpit_tpu_torch.comm.topology import resolve_device
    from mpit_tpu_torch.data import cast_input_dtype, load_mnist
    from mpit_tpu_torch.data.datasets import shard_for_worker
    from mpit_tpu_torch.obs import box_for, wrap_from_env, write_fault_log
    from mpit_tpu_torch.obs.telemetry import TelemetryTransport
    from mpit_tpu_torch.parallel import ps_roles
    from mpit_tpu_torch.parallel.pclient import PClient
    from mpit_tpu_torch.parallel.pserver import PServer, partition_bounds
    from mpit_tpu_torch.run import build_model, build_optimizer
    from mpit_tpu_torch.transport import (
        ChaosTransport,
        SocketTransport,
        config_from_env as chaos_config_from_env,
    )
    from mpit_tpu_torch.utils.params import flatten_params, unflatten_params

    is_server = rank < num_servers
    # a server keeps numpy state only: its model exists on the CPU just to
    # draw the shared init, so it never creates a CUDA context
    device = torch.device("cpu") if is_server else resolve_device(known.device)
    x_tr, y_tr, x_te, y_te = load_mnist(synthetic_train=cfg.train_size)
    x_tr = cast_input_dtype(x_tr, cfg.input_dtype)
    model = build_model(cfg, device)
    opt = build_optimizer(cfg, cfg.steps)
    # identical init on every rank from the shared seed (≡ rank-0 + bcast)
    params0 = model.init(torch.Generator().manual_seed(cfg.seed))
    flat0_t, spec = flatten_params(params0)
    flat0 = flat0_t.cpu().numpy().astype(np.float32, copy=True)

    # chaos opt-in: MPIT_CHAOS_* knobs wrap the socket in the fault
    # injector, the contract of thread mode; each process has its own
    # FaultLog (faults are recorded sender-side, so the per-rank union is
    # the whole schedule). MPIT_CONNECT_RETRY_S: how long a refused
    # outbound connection is retried (startup skew vs a dead peer).
    tp = base = SocketTransport(
        rank, world,
        connect_retry_s=float(os.environ.get("MPIT_CONNECT_RETRY_S", "30")),
    )
    chaos_cfg = chaos_config_from_env()
    fault_log = None
    if chaos_cfg is not None:
        tp = ChaosTransport(tp, chaos_cfg)
        fault_log = tp.log
    # observability opt-in: with any MPIT_OBS_* knob set the transport is
    # wrapped for tracing/telemetry (MPIT_OBS_DIR=/tmp/run writes per-rank
    # journals that `python -m mpit_tpu_torch.obs merge /tmp/run` turns
    # into one Perfetto timeline); unset, this is the identity. Telemetry
    # wraps OUTERMOST over chaos so its stream index stays in lockstep
    # with the chaos schedule (the fault-overlay join key).
    tp = wrap_from_env(tp)
    if fault_log is not None:
        # ride the chaos schedule along every black-box dump
        box = box_for(tp)
        if box is not None:
            box.add_source(
                "faults",
                lambda: [
                    {
                        "ev": "fault", "kind": e.kind, "src": e.src,
                        "dst": e.dst, "tag": e.tag, "n": e.n,
                    }
                    for e in fault_log.events()
                ],
            )
    server_ranks = list(range(num_servers))
    client_ranks = list(range(num_servers, world))
    bounds = partition_bounds(flat0.size, num_servers)

    # sharded ownership opt-in: MPIT_PS_SHARDS=N splits the flat vector
    # into N ring-placed shards so clients reassign a killed server's
    # shards to the survivors instead of skipping its range forever
    ps_shards = int(os.environ.get("MPIT_PS_SHARDS", "0"))
    shard_map = None
    if ps_shards > 0:
        from mpit_tpu_torch.comm.topology import HashRing, ShardMap

        shard_map = ShardMap(HashRing(server_ranks), flat0.size, ps_shards)

    # elastic mode, set by the supervising launcher (MPIT_ELASTIC_RESPAWN=1):
    # clients announce themselves with JOIN so a respawned replacement
    # registers a fresh dedup epoch, servers snapshot their shard for
    # kill→restore recovery, and exchange failures degrade to skipped
    # rounds instead of killing the run
    elastic = os.environ.get("MPIT_ELASTIC_RESPAWN", "0") not in ("", "0")
    ckpt_dir = os.environ.get("MPIT_ELASTIC_CKPT_DIR")
    # elastic implies the dead-client watchdog: a restored server whose
    # snapshot predates some client's STOP would otherwise wait forever
    # for a rank that already exited cleanly and will never speak again
    client_timeout = cfg.client_timeout
    if client_timeout is None and elastic:
        client_timeout = 15.0

    if is_server:
        start, end = bounds[rank]
        if shard_map is not None:
            pieces = [flat0[s:e] for _, s, e in shard_map.ranges_for(rank)]
            center0 = (
                np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
            )
        else:
            center0 = flat0[start:end]
        server = PServer(
            tp, center0,
            num_clients=num_clients, alpha=alpha,
            client_ranks=client_ranks,
            client_timeout=client_timeout,
            ckpt_path=(
                os.path.join(ckpt_dir, f"shard_{rank}.msgpack")
                if ckpt_dir else None
            ),
            ckpt_every=int(os.environ.get("MPIT_ELASTIC_CKPT_EVERY", "5")),
            shard_map=shard_map,
        )
        server.start()  # blocks until every client stopped (or died)
        print(
            f"pserver rank {rank}: counts={server.counts} "
            f"dead_clients={sorted(server.dead_clients)}"
        )
        print(
            f"pserver rank {rank}: cuda initialized="
            f"{torch.cuda.is_initialized()}"
        )
    else:
        c = rank - num_servers
        hb = client_timeout / 3 if client_timeout else None
        client = PClient(
            tp, server_ranks, flat0.size, heartbeat_interval=hb,
            # elastic: a killed server respawns within seconds — short
            # attempts and skipped rounds instead of the default 60 s wait
            timeout=float(
                os.environ.get("MPIT_PS_TIMEOUT")
                or (15.0 if elastic else 60.0)
            ),
            max_retries=int(os.environ.get("MPIT_PS_MAX_RETRIES", "3")),
            shard_map=shard_map,
        )
        xs = shard_for_worker(torch.as_tensor(x_tr).to(device), c, num_clients)
        ys = shard_for_worker(torch.as_tensor(y_tr).to(device), c, num_clients)
        local_step = ps_roles.make_local_step(model, opt)
        per_client = max(cfg.global_batch // num_clients, 1)
        # first-call set-up (CUDA context, cuDNN and cuBLAS handles, kernel
        # loading) outside the clock: one local step on throwaway state
        local_step(params0, opt.init(params0), xs[:per_client], ys[:per_client])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        # ...and the servers' start-up: connect (and negotiate) to every
        # server now, as the first fetch would, so the clock starts when
        # they listen
        for r in server_ranks:
            with base._dst_lock(r):
                base._connection(r)
        exchange = {}
        t0 = time.perf_counter()
        losses = ps_roles.client_train_loop(
            client, local_step, opt, spec, xs, ys,
            steps=cfg.steps, batch_size=per_client, tau=cfg.tau,
            algo=cfg.resolved_algo().removeprefix("ps-")
            if cfg.algo.startswith("ps-") else "easgd",
            alpha=alpha, seed=cfg.seed + 1000 + c,
            join=elastic,
            max_exchange_failures=8 if elastic else None,
            exchange_stats=exchange,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        samples = cfg.steps * per_client
        rounds = exchange.get("rounds", 0)
        print(
            f"pclient {c}: trained {samples} samples in {wall:.6f} s of its "
            f"training loop, {samples / wall:.1f} samples/s on {device.type}; "
            f"exchange {1e3 * exchange.get('exchange_s', 0.0) / max(rounds, 1):.3f} "
            f"ms per round over {rounds} rounds"
        )
        if c == 0:
            # final center fetch BEFORE stop (servers still serving)
            fetched = np.ascontiguousarray(client.fetch(), np.float32)
            center = unflatten_params(spec, torch.as_tensor(fetched).to(device))
            correct = 0
            n = (len(x_te) // 512) * 512 or len(x_te)
            with torch.no_grad():
                for i in range(0, n, 512):
                    xb = torch.as_tensor(x_te[i : i + 512]).to(device)
                    logits = model.apply(center, xb)
                    correct += int(
                        (logits.argmax(-1).cpu().numpy() == y_te[i : i + 512]).sum()
                    )
            print(
                f"pclient 0: test acc={correct / n:.4f} "
                f"final loss={losses[-1]:.4f}"
            )
            print(
                "pclient 0: fetched center sha256="
                + hashlib.sha256(fetched.tobytes()).hexdigest()
            )
        client.stop()
    if fault_log is not None:
        print(f"rank {rank}: chaos faults {fault_log.counts()}")
    if isinstance(tp, TelemetryTransport):
        # the rank's wire counters, with the socket's receive-side split
        # (rx_phase_s: transfer and deserialize per src:tag) beside the
        # send-side one (phase_s per dst:tag)
        print(f"rank {rank}: telemetry {json.dumps(tp.summary())}")
    obs_dir = os.environ.get("MPIT_OBS_DIR")
    if fault_log is not None and obs_dir:
        # per-rank fault log for the merger's --faults overlay (a
        # directory of faults_rank*.jsonl is accepted there)
        write_fault_log(
            fault_log.events(),
            os.path.join(obs_dir, f"faults_rank{rank}.jsonl"),
        )
    tp.close()


if __name__ == "__main__":
    main()
