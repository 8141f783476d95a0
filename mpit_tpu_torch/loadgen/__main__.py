"""Seeded load run against a tiny in-process server, journaled for
``obs slo``; a copy of ``mpit_tpu/loadgen/__main__.py`` on the port's
servers (on the card unless ``--device cpu``).

    python -m mpit_tpu_torch.loadgen --out /tmp/serve_obs --seed 3 \\
        --requests 48 --rate 200 --cancel-prob 0.1

builds a smoke-sized model (transformer by default, ``--rnn`` for the
carry-decode family), drives the open-loop harness against it with the
server journaling every request lifecycle into ``--out``, and prints
one JSON report line (the same reduction ``obs slo`` computes). Chain::

    python -m mpit_tpu_torch.obs slo /tmp/serve_obs --gate scripts/slo_smoke.json

Every knob that shapes the run is on the command line and the run is a
pure function of them — rerunning a failed soak's line replays it.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.loadgen",
        description="seeded open-loop load run against an in-process "
        "server, journaled for `python -m mpit_tpu_torch.obs slo`",
    )
    p.add_argument("--out", required=True,
                   help="journal directory (created if missing)")
    p.add_argument("--seed", type=int, default=0,
                   help="workload + chaos seed (default 0)")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--rate", type=float, default=200.0,
                   help="Poisson arrival rate, req/s (default 200)")
    p.add_argument("--cancel-prob", type=float, default=0.0)
    p.add_argument("--rnn", action="store_true",
                   help="serve the LSTM family (RNNServer) instead of "
                   "the transformer")
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--segment", type=int, default=8)
    p.add_argument("--chaos-delay-p", type=float, default=0.0,
                   help="per-boundary stall probability (seeded)")
    p.add_argument("--chaos-delay-s", type=float, default=0.02)
    p.add_argument("--kill-after", type=int, default=None,
                   help="kill the server at this boundary (seeded soak "
                   "crash drill)")
    p.add_argument("--max-records", type=int, default=None,
                   help="journal record cap (journal_cap footer counts "
                   "the drops)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the unjournaled warmup drain; first-run "
                   "first-call costs (kernel builds, allocator growth) "
                   "then land in the measured TTFTs")
    p.add_argument("--device", default=None,
                   help="where the server runs: the card unless this "
                   "names the CPU (--device cpu)")
    p.add_argument("--live", action="store_true",
                   help="arm the live telemetry plane: snapshots in "
                   "<out>/live, watch with `python -m mpit_tpu_torch.obs "
                   "live <out>`")
    p.add_argument("--live-interval", type=float, default=0.25,
                   help="live snapshot export interval, seconds "
                   "(default 0.25 — smoke runs are short)")
    return p


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)

    import torch

    from mpit_tpu_torch.loadgen import (
        LoadHarness, LoadSpec, ServeChaos, aggregate_paths,
        make_workload,
    )
    from mpit_tpu_torch.obs.core import ObsConfig

    vocab = 17
    if ns.rnn:
        from mpit_tpu_torch.models import RNNServer
        from mpit_tpu_torch.models.lstm import LSTMLM

        model = LSTMLM(
            vocab_size=vocab, embed_dim=12, hidden=16, num_layers=2,
            compute_dtype=torch.float32, device=ns.device,
        )
        server_cls, max_len = RNNServer, None
    else:
        from mpit_tpu_torch.models import Server
        from mpit_tpu_torch.models.transformer import TransformerLM

        model = TransformerLM(
            vocab_size=vocab, num_layers=2, d_model=32, num_heads=4,
            max_len=64, compute_dtype=torch.float32, device=ns.device,
        )
        server_cls, max_len = Server, 64
    params = model.init(torch.Generator().manual_seed(0))

    spec = LoadSpec(
        requests=ns.requests, rate=ns.rate, seed=ns.seed,
        cancel_prob=ns.cancel_prob,
    )
    work = make_workload(spec, vocab, max_len=max_len)

    if not ns.no_warmup:
        # run every bucket shape once outside the journal, so measured
        # TTFT is scheduling + compute, not first-call set-up
        warm = server_cls(
            model, params, max_batch=ns.max_batch, segment=ns.segment,
            device=ns.device,
        )
        for r in work:
            warm.submit(list(r.prompt), r.max_new)
        warm.drain()

    srv = server_cls(
        model, params, max_batch=ns.max_batch, segment=ns.segment,
        device=ns.device,
        obs=ObsConfig(
            dir=ns.out, max_records=ns.max_records,
            live=ns.live, live_interval=ns.live_interval,
        ),
    )
    chaos = None
    if ns.chaos_delay_p > 0.0 or ns.kill_after is not None:
        chaos = ServeChaos(
            seed=ns.seed, delay_p=ns.chaos_delay_p,
            delay_s=ns.chaos_delay_s, kill_after=ns.kill_after,
        )
    harness = LoadHarness(srv, work, chaos=chaos)
    rep = harness.run()

    import glob
    import os

    report = aggregate_paths(
        sorted(glob.glob(os.path.join(ns.out, "obs_rank*.jsonl")))
    )
    report["client"] = {
        "submitted": rep.submitted,
        "cancelled": rep.cancelled,
        "killed": rep.killed,
        "boundaries": rep.boundaries,
        "wall_s": round(rep.wall_s, 4),
        "max_submit_lateness_s": round(rep.max_submit_lateness_s, 6),
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
