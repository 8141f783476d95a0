"""mpirun-equivalent local process launcher.

A copy of ``mpit_tpu/launch.py`` (SURVEY.md §1 launcher row, §3(a)): the
reference was started as ``mpirun -n N th asyncsgd/ptest.lua`` — N OS
processes, ranks discovered via MPI, rank→role split inside the script.
This launcher is that layer for the host-async PS mode:

    python -m mpit_tpu_torch.launch -n 3 mpit_tpu_torch/examples/ptest_proc.py [script args...]

It allocates one TCP port per rank, exports the world to each child
(``MPIT_RANK``, ``MPIT_WORLD_SIZE``, ``MPIT_TRANSPORT_HOSTS``), and
supervises: first non-zero exit terminates the rest (the do-better over
MPI's hang-on-dead-rank, SURVEY.md §5). Output is line-prefixed with the
rank, mpirun-style. Single-host by design — across hosts you run one
process per host yourself and set ``MPIT_TRANSPORT_HOSTS`` to the real
addresses (same env contract).

Elastic supervision (docs/ROBUSTNESS.md): with ``MPIT_ELASTIC_RESPAWN=1``
a rank that dies (crash OR the built-in seeded chaos killer,
``MPIT_ELASTIC_KILL_EVERY_S``) is respawned in place — same rank, same
port (SocketTransport sets SO_REUSEADDR; peers reconnect inside their
connect-retry window) — up to ``MPIT_ELASTIC_MAX_RESPAWNS`` times per
rank, with ``MPIT_RESPAWN_GEN`` exported so the child knows its restart
generation.

``--jax-distributed`` (the reference's flag name, kept for its users)
reserves one more port for the coordinator and exports ``MPIT_DISTRIBUTED=1``
and ``JAX_COORDINATOR_ADDRESS``: each rank's ``mpit_tpu_torch.init()``
then joins a ``torch.distributed`` group (NCCL on cards, gloo on the CPU;
``comm/topology.py``), whose collectives cross the processes:

    python -m mpit_tpu_torch.launch -n 2 --jax-distributed mpit_tpu_torch/examples/multihost_sync.py --device cpu

Not ported yet, and refused before any rank starts: the observability
plane — any ``MPIT_OBS_*`` knob, which in the reference also arms the
membership journal and the black-box dumps around kills and exits
(ROADMAP.md item A12).
"""

from __future__ import annotations

import argparse
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time

from mpit_tpu_torch.analysis.runtime import make_lock


def _reserve_ports(n: int) -> tuple[list[socket.socket], list[int]]:
    """Reserve n distinct free TCP ports; the RESERVING SOCKETS STAY OPEN.

    The caller closes each one immediately before spawning the rank that
    will bind it — shrinking the steal window (another process grabbing the
    port between reservation and child bind) from the whole launch sequence
    to one process spawn. The child surfaces a clear error if it loses even
    that race (SocketTransport's bind diagnostic)."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    except BaseException:
        for s in socks:
            s.close()
        raise
    return socks, ports


def _stream(rank: int, pipe, out):
    for line in iter(pipe.readline, b""):
        out.write(f"[{rank}] ".encode() + line)
        out.flush()
    pipe.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.launch", description=__doc__
    )
    p.add_argument("-n", "--np", type=int, required=True, dest="n",
                   help="number of processes (ranks)")
    p.add_argument(
        "--jax-distributed", action="store_true",
        help="also bootstrap a torch.distributed world across the ranks "
             "(the counterpart of the reference's jax.distributed: "
             "collectives across the processes; NCCL on cards, gloo on "
             "the CPU)",
    )
    p.add_argument("script", help="python script to run in every rank")
    p.add_argument("args", nargs=argparse.REMAINDER,
                   help="arguments passed through to the script")
    ns = p.parse_args(argv)
    if ns.n < 1:
        p.error("-n must be >= 1")

    # chaos knobs are inherited by every rank (env passthrough below):
    # fault injection silently active in a "real" run is a support
    # nightmare, so say it loudly once at launch (docs/ROBUSTNESS.md)
    chaos_env = sorted(k for k in os.environ if k.startswith("MPIT_CHAOS_"))
    if chaos_env:
        print(
            "[launch] CHAOS fault injection active in all ranks: "
            + " ".join(f"{k}={os.environ[k]}" for k in chaos_env),
            file=sys.stderr,
        )
    obs_env = sorted(k for k in os.environ if k.startswith("MPIT_OBS_"))
    if obs_env:
        raise NotImplementedError(
            f"observability ({' '.join(obs_env)}: journals, the membership "
            "log and black-box dumps) is not ported to mpit_tpu_torch yet "
            "(ROADMAP.md, item A12)"
        )

    # one extra port for the process group's coordinator (rank 0 binds it)
    reserving, ports = _reserve_ports(ns.n + (1 if ns.jax_distributed else 0))
    coord_sock, coord_port = None, None
    if ns.jax_distributed:
        # released right before rank 0 spawns, as the rank ports are
        coord_sock, coord_port = reserving.pop(), ports.pop()
    hosts = ",".join(f"127.0.0.1:{port}" for port in ports)

    # elastic supervision knobs (docs/ROBUSTNESS.md "Elastic membership")
    elastic = os.environ.get("MPIT_ELASTIC_RESPAWN", "0") not in ("", "0")
    max_respawns = int(os.environ.get("MPIT_ELASTIC_MAX_RESPAWNS", "3"))
    kill_every = float(os.environ.get("MPIT_ELASTIC_KILL_EVERY_S", "0") or 0)
    kill_seed = int(os.environ.get("MPIT_ELASTIC_KILL_SEED", "0"))
    # restrict the killer's victim pool (comma-separated ranks) — the
    # sharded-PS soak leg aims it at the server ranks so every kill
    # exercises reshard/repair, not just client JOIN
    _kill_ranks = os.environ.get("MPIT_ELASTIC_KILL_RANKS", "").strip()
    kill_ranks = (
        {int(r) for r in _kill_ranks.split(",")} if _kill_ranks else None
    )
    # hold a killed rank down for N seconds before respawning it — an
    # immediate respawn (the default) reconnects before its peers even
    # notice; the delay opens a real dead window so failure paths
    # (reshard/repair, dead-rank declaration) actually run
    respawn_delay = float(
        os.environ.get("MPIT_ELASTIC_RESPAWN_DELAY_S", "0") or 0
    )
    procs: list[subprocess.Popen] = []
    streams: list[threading.Thread] = []

    def _spawn(rank: int, gen: int) -> subprocess.Popen:
        env = dict(os.environ)
        env["MPIT_RANK"] = str(rank)
        env["MPIT_WORLD_SIZE"] = str(ns.n)
        env["MPIT_TRANSPORT_HOSTS"] = hosts
        if coord_port is not None:
            env["MPIT_DISTRIBUTED"] = "1"
            env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{coord_port}"
        if elastic:
            env["MPIT_RESPAWN_GEN"] = str(gen)
        proc = subprocess.Popen(
            [sys.executable, ns.script, *ns.args],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        t = threading.Thread(
            target=_stream, args=(rank, proc.stdout, sys.stdout.buffer),
            daemon=True,
        )
        t.start()
        streams.append(t)
        return proc

    try:
        for rank in range(ns.n):
            # release this rank's port only now, right before its process
            # exists (and the coordinator port with rank 0, which binds it)
            if rank == 0 and coord_sock is not None:
                coord_sock.close()
            reserving[rank].close()
            procs.append(_spawn(rank, 0))
    except BaseException:
        # a failed spawn mid-loop must not strand reservations (they'd stay
        # bound for the launcher's lifetime) or leave earlier ranks spinning
        # in connect-retry against ports that will never get a listener
        for s in reserving:
            s.close()
        if coord_sock is not None:
            coord_sock.close()
        for proc in procs:
            proc.terminate()
        raise

    # seeded chaos killer: SIGKILL a random respawnable rank on a timer —
    # the soak harness's preemption source (never the last rank standing,
    # never a rank whose respawn budget is spent)
    gens = [0] * ns.n
    budget = [max_respawns if elastic else 0] * ns.n
    procs_lock = make_lock("launch.procs_lock")
    killer_stop = threading.Event()
    if elastic and kill_every > 0:
        rng_k = random.Random(kill_seed)

        def _killer() -> None:
            while not killer_stop.wait(kill_every):
                with procs_lock:
                    alive = [
                        r for r in range(ns.n) if procs[r].poll() is None
                    ]
                    victims = [
                        r for r in alive
                        if budget[r] > 0
                        and (kill_ranks is None or r in kill_ranks)
                    ]
                    if len(alive) <= 1 or not victims:
                        continue
                    r = rng_k.choice(victims)
                    try:
                        procs[r].kill()
                    except (ProcessLookupError, OSError):
                        continue

        threading.Thread(
            target=_killer, daemon=True, name="mpit-elastic-killer"
        ).start()

    rc = 0
    try:
        remaining = set(range(ns.n))
        world_down = False
        pending: dict = {}  # rank -> monotonic respawn deadline
        while remaining:
            now = time.monotonic()
            for r in sorted(pending):
                if world_down:
                    pending.pop(r)
                    remaining.discard(r)
                    continue
                if now < pending[r]:
                    continue
                pending.pop(r)
                with procs_lock:
                    procs[r] = _spawn(r, gens[r])
                print(
                    f"[launch] rank {r} respawned as gen {gens[r]} "
                    f"after {respawn_delay:g}s hold "
                    f"({budget[r]} respawn(s) left)",
                    file=sys.stderr,
                )
            for r in sorted(remaining):
                if r in pending:
                    continue  # held down: its exit is already handled
                code = procs[r].poll()
                if code is None:
                    continue
                if code == 0:
                    remaining.discard(r)
                    continue
                if world_down:
                    remaining.discard(r)
                    continue
                if budget[r] > 0:
                    # elastic: the rank died with budget left — respawn it
                    # in place (same rank/port, next generation) instead
                    # of taking the world down
                    # budget/gens are read by the killer thread under
                    # procs_lock — mutate them under the same lock
                    with procs_lock:
                        budget[r] -= 1
                        gens[r] += 1
                    if respawn_delay > 0:
                        pending[r] = time.monotonic() + respawn_delay
                        print(
                            f"[launch] rank {r} exited with {code}; "
                            f"holding down {respawn_delay:g}s before "
                            f"gen {gens[r]}",
                            file=sys.stderr,
                        )
                        continue
                    with procs_lock:
                        procs[r] = _spawn(r, gens[r])
                    print(
                        f"[launch] rank {r} exited with {code}; "
                        f"respawned as gen {gens[r]} "
                        f"({budget[r]} respawn(s) left)",
                        file=sys.stderr,
                    )
                    continue
                remaining.discard(r)
                if rc == 0:
                    rc = code
                print(
                    f"[launch] rank {r} exited with {code}; "
                    "terminating the world",
                    file=sys.stderr,
                )
                world_down = True
                for other in sorted(remaining):
                    procs[other].terminate()
            if remaining:
                waitable = [r for r in remaining if r not in pending]
                if waitable:
                    try:
                        procs[min(waitable)].wait(timeout=0.2)
                    except subprocess.TimeoutExpired:
                        pass
                else:
                    # every live rank is held down: a dead proc's wait()
                    # returns instantly, so sleep instead of spinning
                    time.sleep(0.2)
    except KeyboardInterrupt:
        for proc in procs:
            proc.send_signal(signal.SIGINT)
        rc = 130
    finally:
        killer_stop.set()
    for proc in procs:
        proc.wait()
    for t in streams:
        t.join(timeout=2)
    return rc


if __name__ == "__main__":
    sys.exit(main())
