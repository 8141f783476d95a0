"""The port's loadgen against the reference's, on the CPU.

``make_workload`` and ``ServeChaos`` are copies and must draw the
reference's schedules and faults for the same specs; the harness drives
the port's ``Server``/``RNNServer`` with obs on, its journal reduces through
``loadgen.slo``, and ``python -m mpit_tpu_torch.loadgen --out DIR``
chains into ``python -m mpit_tpu_torch.obs slo DIR``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from mpit_tpu.loadgen import LoadSpec as JaxLoadSpec
from mpit_tpu.loadgen import ServeChaos as JaxServeChaos
from mpit_tpu.loadgen import make_workload as jax_make_workload
from mpit_tpu_torch.loadgen import (
    LoadHarness,
    LoadSpec,
    ServeChaos,
    aggregate_paths,
    make_workload,
)
from mpit_tpu_torch.models import RNNServer, Server, generate_fast
from mpit_tpu_torch.models.lstm import LSTMLM
from mpit_tpu_torch.models.transformer import TransformerLM
from mpit_tpu_torch.obs.core import ObsConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 17
SPECS = [
    dict(),
    dict(requests=40, rate=50.0, seed=3, cancel_prob=0.3, temperatures=(0.5, 1.0),
         top_ps=(0.9,)),
    dict(requests=64, rate=50, seed=1,
         prompt_buckets=((8, 64, 0.5), (64, 256, 0.4), (256, 448, 0.1)),
         output_buckets=((16, 64, 1.0),)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and small CPU ops oversubscribed across all of
    them run many times slower. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("spec", range(len(SPECS)))
@pytest.mark.parametrize("max_len", [None, 64, 512])
def test_make_workload_draws_the_reference_schedule(spec, max_len):
    vocab = 10_000 if spec == 2 else V
    want = jax_make_workload(JaxLoadSpec(**SPECS[spec]), vocab, max_len=max_len)
    got = make_workload(LoadSpec(**SPECS[spec]), vocab, max_len=max_len)
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]


@pytest.mark.parametrize("kw", [dict(seed=0, delay_p=0.3), dict(seed=7, delay_p=0.05,
                                delay_s=0.5, kill_after=150), dict(kill_after=0)])
def test_serve_chaos_draws_the_reference_faults(kw):
    want, got = JaxServeChaos(**kw), ServeChaos(**kw)
    assert [got.draw(b) for b in range(200)] == [want.draw(b) for b in range(200)]


@pytest.fixture(scope="module")
def lm():
    model = TransformerLM(V, num_layers=2, d_model=32, num_heads=4, max_len=64,
                          compute_dtype=torch.float32, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def test_harness_journals_every_request_and_results_equal_solo_calls(lm, tmp_path):
    model, params = lm
    work = make_workload(LoadSpec(requests=12, rate=400.0, seed=2, slo_base_ms=60_000.0),
                         V, max_len=64)
    srv = Server(model, params, max_batch=4, segment=4, device="cpu",
                 obs=ObsConfig(dir=str(tmp_path), live=True, live_interval=0.05))
    rep = LoadHarness(srv, work).run()
    assert rep.submitted == 12 and not rep.killed and len(rep.results) == 12
    for rid, req in rep.requests.items():
        assert rep.results[rid] == generate_fast(
            model, params, list(req.prompt), req.max_new, seed=0, device="cpu"), rid
    report = aggregate_paths([str(tmp_path / "obs_rank0.jsonl")])
    assert report["requests"]["finished"] == 12 and report["goodput"] == 1.0
    assert report["ttft"]["count"] == 12 and report["segments"] == rep.boundaries
    assert os.path.exists(tmp_path / "live" / "rank_0.json")


def test_chaos_kill_leaves_requests_unfinished(lm, tmp_path):
    model, params = lm
    work = make_workload(LoadSpec(requests=10, rate=1000.0, seed=4), V, max_len=64)
    srv = Server(model, params, max_batch=2, segment=2, device="cpu",
                 obs=ObsConfig(dir=str(tmp_path)))
    rep = LoadHarness(srv, work, chaos=ServeChaos(seed=1, kill_after=2)).run()
    assert rep.killed and rep.boundaries == 2
    report = aggregate_paths([str(tmp_path / "obs_rank0.jsonl")])
    assert report["requests"]["unfinished"] > 0 and report["goodput"] < 1.0
    assert report["faults"] == {"kill": 1}


def test_rnn_server_under_load(tmp_path):
    model = LSTMLM(vocab_size=V, embed_dim=12, hidden=16, num_layers=2,
                   compute_dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    work = make_workload(LoadSpec(requests=8, rate=400.0, seed=5, cancel_prob=0.25,
                                  cancel_after_s=0.01), V)
    rep = LoadHarness(RNNServer(model, params, max_batch=3, segment=4, device="cpu",
                                obs=ObsConfig(dir=str(tmp_path))), work).run()
    report = aggregate_paths([str(tmp_path / "obs_rank0.jsonl")])
    assert report["requests"]["submitted"] == 8
    assert report["requests"]["finished"] + report["requests"]["cancelled"] == 8
    assert len(rep.results) == report["requests"]["finished"]


@pytest.mark.parametrize("rnn", [False, True], ids=["transformer", "rnn"])
def test_cli_chains_into_obs_slo(tmp_path, rnn):
    out = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "mpit_tpu_torch.loadgen", "--out", str(out),
            "--device", "cpu", "--requests", "8", "--seed", "3", "--cancel-prob", "0.2",
            "--max-batch", "2", "--segment", "4", *(["--rnn"] if rnn else [])]
    r = subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["requests"]["submitted"] == 8 and line["client"]["submitted"] == 8
    r = subprocess.run([sys.executable, "-m", "mpit_tpu_torch.obs", "slo", str(out),
                        "--json"], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    slo = json.loads(r.stdout)
    assert slo["requests"] == line["requests"]
    assert slo["ttft"] == line["ttft"] and slo["tokens"] == line["tokens"]
