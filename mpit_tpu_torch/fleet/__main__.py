"""Fleet CLI: seeded fleet runs, lifecycle audits, and the soak pin; a
copy of ``mpit_tpu/fleet/__main__.py`` on the port's servers, which run on
the card unless ``--device cpu``.

    python -m mpit_tpu_torch.fleet run --out /tmp/fleet --replicas 3 \\
        --requests 24 --kill-after 2 --kill-rank 1

drives one workload through the router + N replicas (threads over the
in-process broker by default; ``--procs`` spawns each replica as an OS
process speaking the framed ``SocketTransport``, the deployment shape),
writes the router's lifecycle journal into ``--out``, and prints one
JSON report line. Chain::

    python -m mpit_tpu_torch.fleet audit /tmp/fleet
    python -m mpit_tpu_torch.obs slo /tmp/fleet --gate scripts/fleet_smoke.json

Subcommands:

``run``      one seeded fleet run (kill leg, rolling weight refresh,
             controller) — a pure function of its flags; rerunning a
             failed soak's line replays it.
``replica``  the subprocess entry ``run --procs`` spawns per replica
             rank; world discovery via the ``mpit_tpu_torch.launch`` env
             contract (``MPIT_RANK``/``MPIT_WORLD_SIZE``/
             ``MPIT_TRANSPORT_HOSTS``).
``audit``    replay a run's router journal into the zero-lost verdict
             (exit 1 when any routed request never finished).
``pin``      compare a clean run dir against a chaos run dir: the kill
             may move p99 but must not move p50 (factor gate) and must
             lose nothing — the fleet soak's pass/fail core.

Env knobs (all overridable by flags): ``MPIT_FLEET_POLICY``
(p2c|least), ``MPIT_FLEET_MAX_OUTSTANDING`` (0 = unlimited admission),
``MPIT_FLEET_QUANT`` (off|bf16|int8 weight-push encoding),
``MPIT_FLEET_DETECT_TIMEOUT_S`` (process-mode death-detect patience).

The model is the reference's smoke model (vocab 17, 2 layers, d_model 32,
4 heads, max_len 64, f32), its weights drawn from ``--seed`` as the port
draws them (``model.init(torch.Generator().manual_seed(seed))``). Under
``--procs`` each replica process builds it on ``--device`` itself, and
with ``--out`` its exit summary (the reference's keys plus ``pid``,
``device`` and ``cuda_initialized``) lands in ``<out>/rep<rank>.out``;
the router process keeps its weight source on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _build_model(seed: int = 0, device=None):
    import torch

    from mpit_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(
        vocab_size=17, num_layers=2, d_model=32, num_heads=4,
        max_len=64, compute_dtype=torch.float32, device=device,
    )
    params = model.init(torch.Generator().manual_seed(seed))
    return model, params


def _server_factory(out, max_batch, segment, seed=0, device=None):
    from mpit_tpu_torch.models import Server
    from mpit_tpu_torch.obs.core import ObsConfig

    model, params = _build_model(seed, device)

    def factory(rank: int):
        obs = (
            ObsConfig(dir=os.path.join(out, f"rep{rank}"))
            if out else None
        )
        return Server(
            model, params, max_batch=max_batch, segment=segment, obs=obs,
            device=device,
        )

    return factory, params


# -- replica: the subprocess entry ------------------------------------------


def _main_replica(argv) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.fleet replica",
        description="one fleet replica over SocketTransport; world from "
        "MPIT_RANK/MPIT_WORLD_SIZE/MPIT_TRANSPORT_HOSTS",
    )
    p.add_argument("--out", default=None, help="obs base dir (journals "
                   "land in <out>/rep<rank>)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=2)
    p.add_argument("--segment", type=int, default=4)
    p.add_argument("--router-rank", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="where the replica serves: the card unless this "
                   "names the CPU (--device cpu)")
    ns = p.parse_args(argv)

    rank = int(os.environ["MPIT_RANK"])
    size = int(os.environ["MPIT_WORLD_SIZE"])

    from mpit_tpu_torch.fleet.replica import ReplicaServer
    from mpit_tpu_torch.transport.socket_transport import SocketTransport

    factory, _params = _server_factory(
        ns.out, ns.max_batch, ns.segment, seed=ns.seed, device=ns.device
    )
    transport = SocketTransport(rank, size)
    server = factory(rank)
    rep = ReplicaServer(server, transport, router_rank=ns.router_rank)
    rep.subscribe_weights()
    try:
        summary = rep.run()
    finally:
        rep.close()
        transport.close()
    import torch

    summary.update(
        pid=os.getpid(), device=str(server.device),
        cuda_initialized=torch.cuda.is_initialized(),
    )
    print(json.dumps(summary))
    return 0


# -- run: one fleet run ------------------------------------------------------


def _proc_harness(out, max_batch, segment, model_seed, device=None,
                  **kwargs):
    """A ``FleetHarness`` whose replicas are OS processes: reserved
    ports, ``replica``-subcommand children over ``SocketTransport``,
    SIGKILL as the chaos kill, waitpid as death detection. Defined
    lazily so the in-process path never pays the import."""
    from mpit_tpu_torch.fleet.harness import FleetHarness
    from mpit_tpu_torch.launch import _reserve_ports

    class ProcFleetHarness(FleetHarness):
        def __init__(self):
            super().__init__(lambda rank: None, **kwargs)
            self._procs: dict = {}
            self._stopping = False
            self._detect_timeout_s = float(
                os.environ.get("MPIT_FLEET_DETECT_TIMEOUT_S", "60")
            )

        def _make_world(self, size: int) -> None:
            from mpit_tpu_torch.transport.socket_transport import (
                SocketTransport,
            )

            socks, ports = _reserve_ports(size)
            self._hosts = ",".join(
                f"127.0.0.1:{port}" for port in ports
            )
            self._addrs = [("127.0.0.1", port) for port in ports]
            for s in socks:
                s.close()  # rank 0 binds now, children bind theirs
            self._transports = {
                0: SocketTransport(0, size, addresses=self._addrs)
            }

        def _spawn_replica(self, rank: int) -> None:
            env = dict(os.environ)
            env["MPIT_RANK"] = str(rank)
            env["MPIT_WORLD_SIZE"] = str(len(self._addrs))
            env["MPIT_TRANSPORT_HOSTS"] = self._hosts
            cmd = [
                sys.executable, "-m", "mpit_tpu_torch.fleet", "replica",
                "--seed", str(model_seed),
                "--max-batch", str(max_batch),
                "--segment", str(segment),
            ]
            if device is not None:
                cmd += ["--device", str(device)]
            stdout = subprocess.DEVNULL
            if out:
                cmd += ["--out", out]
                stdout = open(os.path.join(out, f"rep{rank}.out"), "w")
            try:
                self._procs[rank] = subprocess.Popen(
                    cmd, env=env,
                    stdout=stdout, stderr=subprocess.DEVNULL,
                )
            finally:
                if stdout is not subprocess.DEVNULL:
                    stdout.close()

        def _kill_replica(self, rank: int) -> None:
            proc = self._procs.get(rank)
            if proc is not None and proc.poll() is None:
                proc.kill()

        def _replica_dead(self, rank: int) -> bool:
            proc = self._procs.get(rank)
            return (
                proc is not None
                and proc.poll() is not None
                and not self._stopping
            )

        def _join_replicas(self) -> None:
            self._stopping = True
            deadline = time.monotonic() + self._detect_timeout_s
            for proc in self._procs.values():
                try:
                    proc.wait(
                        timeout=max(0.1, deadline - time.monotonic())
                    )
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()

    return ProcFleetHarness()


def _main_run(argv) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.fleet run",
        description="seeded fleet run: router + N replicas, optional "
        "kill leg / rolling weight refresh / controller; one JSON "
        "report line",
    )
    p.add_argument("--out", required=True,
                   help="router journal dir (created if missing); "
                   "replica journals land in <out>/rep<rank>")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--rate", type=float, default=200.0)
    p.add_argument("--slo-ms", type=float, default=60_000.0)
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--spares", type=int, default=0)
    p.add_argument("--policy", default=None,
                   help="p2c|least (default: $MPIT_FLEET_POLICY or p2c)")
    p.add_argument("--max-outstanding", type=int, default=None,
                   help="admission cap (default: "
                   "$MPIT_FLEET_MAX_OUTSTANDING or unlimited)")
    p.add_argument("--kill-after", type=int, default=None,
                   help="kill --kill-rank at this router boundary")
    p.add_argument("--kill-rank", type=int, default=1)
    p.add_argument("--refresh-at", default="",
                   help="comma-separated router boundaries for rolling "
                   "weight refreshes (e.g. 4,8)")
    p.add_argument("--quant", default=None,
                   help="weight-push encoding off|bf16|int8 (default: "
                   "$MPIT_FLEET_QUANT or off)")
    p.add_argument("--controller", action="store_true",
                   help="route deaths through the alert->action control "
                   "plane (spawns into --spares) instead of bare "
                   "mark_dead")
    p.add_argument("--procs", action="store_true",
                   help="replicas as OS processes over SocketTransport "
                   "(default: threads over the in-process broker)")
    p.add_argument("--max-batch", type=int, default=2)
    p.add_argument("--segment", type=int, default=4)
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the unjournaled warmup drain (in-process "
                   "mode only)")
    p.add_argument("--device", default=None,
                   help="where the replicas serve: the card unless this "
                   "names the CPU (--device cpu); --procs passes it on")
    ns = p.parse_args(argv)

    from mpit_tpu_torch.fleet import (
        FleetHarness, StaticWeightSource, audit_lifecycle,
    )
    from mpit_tpu_torch.loadgen import LoadSpec, ServeChaos, make_workload
    from mpit_tpu_torch.loadgen.slo import aggregate_paths

    spec = LoadSpec(
        requests=ns.requests, rate=ns.rate, seed=ns.seed, cancel_prob=0.0,
    )
    work = make_workload(spec, 17, max_len=64)
    for r in work:
        r.slo_ms = ns.slo_ms

    chaos = (
        ServeChaos(seed=ns.seed, kill_after=ns.kill_after)
        if ns.kill_after is not None else None
    )
    refresh = tuple(
        int(b) for b in ns.refresh_at.split(",") if b.strip()
    )
    quant = ns.quant or os.environ.get("MPIT_FLEET_QUANT", "off")

    # under --procs the router only flattens the source: keep it off the card
    _model, params = _build_model(
        ns.seed, "cpu" if ns.procs else ns.device
    )
    source = StaticWeightSource(params, version=1) if (
        refresh or quant != "off"
    ) else None

    def bump(version):
        from mpit_tpu_torch.utils.params import tree_map

        return tree_map(lambda a: a + 1e-3 * version, params)

    common = dict(
        requests=work,
        n_replicas=ns.replicas,
        spares=ns.spares,
        policy=ns.policy,
        seed=ns.seed,
        obs_dir=ns.out,
        max_outstanding=(
            ns.max_outstanding if ns.max_outstanding is not None
            else int(os.environ.get("MPIT_FLEET_MAX_OUTSTANDING", "0"))
        ),
        chaos=chaos,
        kill_rank=ns.kill_rank,
        source=source,
        quant=quant,
        refresh_boundaries=refresh,
        refresh_params_fn=bump if refresh else None,
        use_controller=ns.controller,
    )
    if ns.procs:
        harness = _proc_harness(
            ns.out, ns.max_batch, ns.segment, ns.seed, device=ns.device,
            **common
        )
    else:
        factory, _p = _server_factory(
            ns.out, ns.max_batch, ns.segment, seed=ns.seed, device=ns.device
        )
        if not ns.no_warmup:
            # run every bucket shape outside the journals, so the
            # kill-vs-clean pin compares scheduling, not first-call set-up
            from mpit_tpu_torch.models import Server

            warm = Server(
                _model, params,
                max_batch=ns.max_batch, segment=ns.segment, device=ns.device,
            )
            for r in work:
                warm.submit(list(r.prompt), r.max_new)
            warm.drain()
            warm.close()
        harness = FleetHarness(factory, **common)
    rep = harness.run()

    audit = audit_lifecycle([ns.out])
    report = aggregate_paths(
        sorted(
            os.path.join(ns.out, f)
            for f in os.listdir(ns.out)
            if f.startswith("obs_rank") and f.endswith(".jsonl")
        )
    )
    report["replica_count"] = ns.replicas
    report["router_policy"] = (
        ns.policy or os.environ.get("MPIT_FLEET_POLICY", "p2c")
    )
    report["fleet"] = {
        "admitted": audit["admitted"],
        "finished": audit["finished"],
        "redispatched": audit["redispatched"],
        "shed": audit["shed"],
        "lost": audit["lost"],
        "dead_replicas": audit["dead_replicas"],
        "versions_monotonic": audit["versions_monotonic"],
        "ok": audit["ok"],
    }
    report["client"] = {
        "submitted": rep.submitted,
        "killed_ranks": rep.killed_ranks,
        "dead_ranks": rep.dead_ranks,
        "spawned_ranks": rep.spawned_ranks,
        "redispatched": rep.redispatched,
        "boundaries": rep.boundaries,
        "wall_s": round(rep.wall_s, 4),
    }
    print(json.dumps(report))
    return 0 if audit["ok"] else 1


# -- audit -------------------------------------------------------------------


def _main_audit(argv) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.fleet audit",
        description="replay a fleet run's router journal into the "
        "zero-lost verdict",
    )
    p.add_argument("paths", nargs="+",
                   help="router journal dir(s) or obs_rank*.jsonl files")
    p.add_argument("--json", action="store_true")
    ns = p.parse_args(argv)

    from mpit_tpu_torch.fleet import audit_lifecycle, format_audit

    audit = audit_lifecycle(ns.paths)
    if ns.json:
        print(json.dumps(audit, indent=2))
    else:
        print(format_audit(audit))
    return 0 if audit["ok"] and audit["versions_monotonic"] else 1


# -- pin: clean-vs-chaos p50/p99 ---------------------------------------------


def _main_pin(argv) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.fleet pin",
        description="the soak's core claim: a replica kill may move p99 "
        "but must not move p50 (same-seed clean run as the baseline), "
        "and must lose zero admitted requests",
    )
    p.add_argument("clean", help="clean run's router journal dir")
    p.add_argument("chaos", help="kill run's router journal dir")
    p.add_argument("--p50-factor", type=float, default=3.0,
                   help="max allowed chaos-p50 / clean-p50 (default 3.0 "
                   "— generous: CI CPUs are noisy, the LOST gate is the "
                   "sharp one)")
    p.add_argument("--expect-kill", action="store_true",
                   help="additionally require the chaos run to name a "
                   "dead replica and a redispatch (the fault actually "
                   "fired)")
    p.add_argument("--json", action="store_true")
    ns = p.parse_args(argv)

    from mpit_tpu_torch.fleet import audit_lifecycle
    from mpit_tpu_torch.loadgen.slo import aggregate_paths

    def _load(d):
        paths = sorted(
            os.path.join(d, f) for f in os.listdir(d)
            if f.startswith("obs_rank") and f.endswith(".jsonl")
        )
        return audit_lifecycle([d]), aggregate_paths(paths)

    clean_audit, clean_rep = _load(ns.clean)
    chaos_audit, chaos_rep = _load(ns.chaos)
    failures = []
    for name, audit in (("clean", clean_audit), ("chaos", chaos_audit)):
        if not audit["ok"]:
            failures.append(
                f"{name}: lost={audit['lost']} unrouted={audit['unrouted']}"
            )
        if not audit["versions_monotonic"]:
            failures.append(f"{name}: weight version regression")
    p50_clean = clean_rep.get("e2e", {}).get("p50_ms")
    p50_chaos = chaos_rep.get("e2e", {}).get("p50_ms")
    if p50_clean is None or p50_chaos is None:
        failures.append("missing e2e p50 samples")
    elif p50_chaos > p50_clean * ns.p50_factor:
        failures.append(
            f"p50 moved: {p50_chaos}ms > {p50_clean}ms x {ns.p50_factor}"
        )
    if ns.expect_kill:
        if not chaos_audit["dead_replicas"]:
            failures.append("chaos run killed no replica")
        elif not chaos_audit["redispatched"] and chaos_audit["lost"]:
            failures.append("kill orphaned requests without redispatch")
    verdict = {
        "ok": not failures,
        "failures": failures,
        "p50_ms": {"clean": p50_clean, "chaos": p50_chaos},
        "p99_ms": {
            "clean": clean_rep.get("e2e", {}).get("p99_ms"),
            "chaos": chaos_rep.get("e2e", {}).get("p99_ms"),
        },
        "killed": chaos_audit["dead_replicas"],
        "redispatched": chaos_audit["redispatched"],
    }
    if ns.json:
        print(json.dumps(verdict, indent=2))
    else:
        print(
            "pin: p50 clean {clean}ms chaos {chaos}ms; p99 {pc}ms -> "
            "{px}ms; killed {k}; redispatched {r}".format(
                clean=p50_clean, chaos=p50_chaos,
                pc=verdict["p99_ms"]["clean"], px=verdict["p99_ms"]["chaos"],
                k=verdict["killed"], r=verdict["redispatched"],
            )
        )
        for f in failures:
            print(f"  FAIL {f}")
        print("pin: " + ("OK" if not failures else "FAILED"))
    return 0 if not failures else 1


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    cmds = {
        "run": _main_run,
        "replica": _main_replica,
        "audit": _main_audit,
        "pin": _main_pin,
    }
    if argv and argv[0] in cmds:
        return cmds[argv[0]](argv[1:])
    print(
        "usage: python -m mpit_tpu_torch.fleet {run|replica|audit|pin} ...",
        file=sys.stderr,
    )
    return 2


if __name__ == "__main__":
    sys.exit(main())
