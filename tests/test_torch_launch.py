"""Process mode of the port: the launcher and ``ptest_proc.py`` as OS
processes over TCP, against the reference's counts.

``python -m mpit_tpu_torch.launch`` is a copy of ``mpit_tpu/launch.py``
and ``mpit_tpu_torch/examples/ptest_proc.py`` of ``examples/ptest_proc.py``;
the cases of ``tests/test_launch.py`` run here on the port (on the CPU).
One world mixes the packages, started without a launcher: rank 0 is the
reference's script under ``JAX_PLATFORMS=cpu``, ranks 1-2 the port's, and
it trains with the reference's counts. What is not ported raises naming
its ROADMAP.md item before any rank starts.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

from mpit_tpu_torch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPT = os.path.join(REPO, "mpit_tpu_torch", "examples", "ptest_proc.py")
REF_SCRIPT = os.path.join(REPO, "examples", "ptest_proc.py")
MULTIHOST = os.path.join(REPO, "mpit_tpu_torch", "examples", "multihost_sync.py")
ARGS = ["--model", "mlp", "--steps", "12", "--train-size", "512"]
TIMEOUT_S = 180


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MPIT_RANK", "MPIT_WORLD_SIZE", "MPIT_TRANSPORT_HOSTS",
                                "MPIT_CHAOS_", "MPIT_OBS_", "MPIT_ELASTIC_",
                                "MPIT_DISTRIBUTED", "JAX_COORDINATOR"))}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _launch(n, script_args):
    return subprocess.run(
        [sys.executable, "-m", "mpit_tpu_torch.launch", "-n", str(n), PORT_SCRIPT,
         "--device", "cpu", *script_args],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S,
    )


def test_three_process_ps_easgd_trains():
    r = _launch(3, [*ARGS, "--algo", "ps-easgd"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "test acc=" in r.stdout
    assert "pserver rank 0" in r.stdout
    assert "dead_clients=[]" in r.stdout
    # 2 clients, tau=4 (default), 12 steps -> 3 pushes each
    assert "'push_easgd': 6" in r.stdout
    assert "pserver rank 0: cuda initialized=False" in r.stdout
    assert r.stdout.count("training loop, ") == 2


def test_failed_rank_terminates_world():
    """A rank exiting non-zero brings the job down (not a hang)."""
    r = _launch(2, ["--model", "mlp", "--steps", "4", "--servers", "2"])
    # 2 ranks, 2 servers -> no clients: every rank exits with SystemExit
    assert r.returncode != 0
    assert "leaves no clients" in r.stdout + r.stderr


def test_a_mixed_world_trains_with_the_reference_counts():
    """Rank 0 is the reference's pserver (JAX on the CPU), ranks 1-2 the
    port's pclients, over real sockets with the environment a launcher
    exports: the server counts what the reference's own world counts."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_STREAM) for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    hosts = ",".join(f"127.0.0.1:{s.getsockname()[1]}" for s in socks)
    for s in socks:
        s.close()
    procs = []
    try:
        for rank in range(3):
            env = dict(_env(), MPIT_RANK=str(rank), MPIT_WORLD_SIZE="3",
                       MPIT_TRANSPORT_HOSTS=hosts)
            cmd = ([sys.executable, REF_SCRIPT, *ARGS] if rank == 0 else
                   [sys.executable, PORT_SCRIPT, "--device", "cpu", *ARGS])
            procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0, 0], "\n".join(outs)
    assert "'push_easgd': 6" in outs[0] and "'fetch': 9" in outs[0]
    assert "dead_clients=[]" in outs[0]
    assert "pclient 0: test acc=" in outs[1]


@pytest.mark.parametrize("case", ["jax-distributed", "obs"])
def test_unported_launch_planes_raise_naming_their_item(case, monkeypatch, tmp_path):
    """The obs plane (item A12) raises naming its item before any rank
    starts. ``--jax-distributed``, which raised until item A5b landed,
    now wires a ``torch.distributed`` world: two gloo ranks of
    ``multihost_sync.py`` train as one world of 2 × 1 workers."""
    if case == "jax-distributed":
        out = str(tmp_path / "mh")
        r = subprocess.run(
            [sys.executable, "-m", "mpit_tpu_torch.launch", "-n", "2",
             "--jax-distributed", MULTIHOST, "--device", "cpu", "--steps", "4",
             "--out", out],
            cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S,
        )
        assert r.returncode == 0, r.stdout + r.stderr
        ranks = [json.load(open(f"{out}.rank{i}.json")) for i in range(2)]
        assert [m["num_workers"] for m in ranks] == [2, 2]
        assert ranks[0]["last_loss"] == ranks[1]["last_loss"]
        return
    argv = ["-n", "2", PORT_SCRIPT]
    monkeypatch.setenv("MPIT_OBS_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="item A12"):
        launch.main(argv)
    assert not os.listdir(tmp_path)
