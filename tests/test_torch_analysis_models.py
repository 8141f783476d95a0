"""The port analyzer's models and CLI (``python -m mpit_tpu_torch.analysis
mcheck|threads|schema|numerics|conform|fuzz|--fix``) against the
reference's, each run in this process on the same inputs: the port's
package, the checked-in journals (``tests/fixtures/conformance/``) and the
frozen wire corpus. The protocol half answers as the reference's does; the
precision-flow model reads the port's torch quantized exchange, which the
reference's cannot see."""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

from mpit_tpu.analysis.__main__ import main as ref_main
from mpit_tpu_torch.analysis.__main__ import main as port_main

REPO = Path(__file__).resolve().parent.parent
PKG = str(REPO / "mpit_tpu_torch")
CONF = Path(__file__).resolve().parent / "fixtures" / "conformance"
CORPUS = Path(__file__).resolve().parent / "fixtures" / "wire_corpus" / "corpus.jsonl"
LOCK = REPO / "wire-schema.lock.json"
# the reference analyzer's state counts on the port's protocol
STATES = {"easgd": 12134, "downpour": 20619, "easgd-elastic": 13648,
          "easgd-sharded": 107575, "fleet-route": 501}


def _cli(main, *argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _both(*argv):
    return _cli(port_main, *argv), _cli(ref_main, *argv)


def _semantics(lint, mcheck, protocol):
    """The protocol models one analyzer extracts from the port (what its
    ``mcheck`` explores), as plain data."""
    mods = [m for ap, rel in lint.collect_files([PKG])
            if (m := lint.load_module(ap, rel)) is not None]
    project = lint.Project(modules=mods, config=lint.Config())
    return (dataclasses.asdict(mcheck.from_protocol(protocol.extract_semantics(project))),
            dataclasses.asdict(mcheck.fleet_from_protocol(
                protocol.extract_fleet_semantics(project))))


@pytest.fixture(scope="module")
def mcheck_runs():
    """The port's ``mcheck`` on the port, and whether both analyzers
    extract the same models from it (the checkers are the same code, so
    the same models explore the same states: the reference's counts)."""
    from mpit_tpu.analysis import lint as ref_lint, mcheck as ref_mcheck
    from mpit_tpu.analysis import protocol as ref_protocol
    from mpit_tpu_torch.analysis import lint, mcheck, protocol

    rc, out, _ = _cli(port_main, "mcheck", "--package", PKG, "--json")
    assert rc == 0
    same = _semantics(lint, mcheck, protocol) == _semantics(ref_lint, ref_mcheck, ref_protocol)
    return {e["config"].split(",")[0]: e for e in json.loads(out)}, same


@pytest.mark.parametrize("config", sorted(STATES))
def test_mcheck_explores_the_references_states_on_the_port(config, mcheck_runs):
    port, same_models = mcheck_runs
    assert same_models
    assert port[config]["states"] == STATES[config]
    assert port[config]["violations"] == {} and not port[config]["truncated"]


@pytest.mark.parametrize("args", [("--json",), ("--owner", "PServer", "--json")])
def test_threads_model_equals_the_references(args):
    port, ref = _both("threads", "--package", PKG, *args)
    assert port == ref and port[0] == 0
    assert json.loads(port[1])


def test_schema_matches_the_shared_lock_as_the_reference_infers_it():
    port, ref = _both("schema", "--package", PKG, "--json")
    assert port == ref
    rc, out, _ = _cli(port_main, "schema", "--package", PKG, "--check")
    assert (rc, out) == (0, "wire schema: 15 tag(s) match wire-schema.lock.json\n")


def test_update_lock_writes_only_an_explicit_path(tmp_path):
    before = LOCK.read_bytes()
    rc, _, err = _cli(port_main, "schema", "--package", PKG, "--update-lock")
    assert rc == 2 and "explicit --lock" in err
    rc, out, _ = _cli(port_main, "schema", "--package", PKG, "--update-lock",
                      "--lock", str(tmp_path / "lock.json"))
    assert rc == 0 and out.startswith("wrote 15 tag schema(s)")
    # the port's frames are the reference's: its scan writes the shared lock
    assert (tmp_path / "lock.json").read_bytes() == before == LOCK.read_bytes()


@pytest.fixture(scope="module")
def numerics_docs():
    (prc, pout, _), (rrc, rout, _) = _both("numerics", "--package", PKG, "--json")
    assert prc == rrc == 0
    return json.loads(pout), json.loads(rout)


@pytest.mark.parametrize("where, func, symbol, ef", [
    ("comm/collectives.py", "quantize_rows_torch", "quantized_rows_encode", "paired"),
    ("comm/collectives.py", "quantize_rows_torch", "quantized_rows_reduce", "paired"),
    ("comm/collectives.py", "_quantized_hop1", "quantized_psum_scatter", "ef-off"),
    ("parallel/sync.py", "quantized_rows_encode", "DataParallelTrainer._bucketed_step", "paired"),
    ("parallel/sync.py", "quantized_rows_reduce", "DataParallelTrainer._bucketed_step", "paired"),
])
def test_numerics_reads_the_ports_quantized_exchange(where, func, symbol, ef, numerics_docs):
    """The reference's verdicts on its counterparts: the allreduce's
    quantizations paired with error feedback, the ZeRO scatter declared
    stateless."""
    port, _ = numerics_docs
    hits = [q for q in port["quant_sites"] if q["site"].split(":")[0].endswith(where)
            and q["func"] == func and q["symbol"] == symbol]
    assert [q["ef"] for q in hits] == [ef]
    if ef == "ef-off":
        assert hits[0]["ef_off_reason"] == "ZeRO scatter is stateless by design"


def _calls(rel, names):
    tree = ast.parse((REPO / "mpit_tpu_torch" / rel).read_text())
    return [f"mpit_tpu_torch/{rel}:{n.lineno}" for n in ast.walk(tree)
            if isinstance(n, ast.Call) and ast.unparse(n.func).split(".")[-1] in names]


def test_numerics_lists_every_torch_quantize_site_and_the_references_host_faces(numerics_docs):
    port, ref = numerics_docs
    listed = {q["site"] for q in port["quant_sites"]}
    kernels = _calls("comm/collectives.py", {"quantize_rows_torch"})
    helpers = _calls("parallel/sync.py", {"quantized_rows_encode", "quantized_rows_reduce"})
    assert len(kernels) == len(helpers) == 2 and listed >= {*kernels, *helpers}
    assert len(port["quant_sites"]) > len(ref["quant_sites"]) == 8
    assert port["reduce_sites"] == [] and port["tags"] == ref["tags"]
    # the host faces (the PS pushes, fetch replies, fleet weights, fuzz)
    # are the reference's sites and verdicts
    outside = [q for q in port["quant_sites"]
               if not q["site"].startswith(("mpit_tpu_torch/comm/", "mpit_tpu_torch/parallel/sync"))]
    assert outside == ref["quant_sites"]


@pytest.mark.parametrize("run, rc, lines", [("good_run", 0, 1), ("bad_run", 1, 5)])
def test_conform_replays_the_journals_as_the_reference(run, rc, lines):
    port, ref = _both("conform", str(CONF / run), "--package", PKG)
    assert port == ref and port[0] == rc
    out = port[1].splitlines()
    assert len(out) == lines and out[-1].startswith("0 violation(s)" if rc == 0 else "4 violation(s)")
    assert sorted({ln.split(":")[0] for ln in out[:-1]}) == (
        [] if rc == 0 else ["TC201", "TC202", "TC203"])


def test_fuzz_gate_prints_the_references_line():
    port, ref = _both("fuzz", "--examples", "50", "--corpus", str(CORPUS))
    assert port == ref and port[0] == 0
    assert port[1].startswith("fuzz gate ok: 50 example(s) (seed 0)")


def test_fix_rewrites_a_copy_as_the_reference_does(tmp_path):
    """``--fix`` on files in ``tmp_path`` only: the literal tag becomes its
    registry name, imported from the port's pserver where the reference
    imports its own."""
    src = "def g(transport, x):\n    transport.send(0, 4, x)\n    transport.send(0, 42, x)\n"
    for name in ("port", "ref"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "mod.py").write_text(src)
    port = _cli(port_main, "--fix", "--no-baseline", str(tmp_path / "port" / "mod.py"))
    ref = _cli(ref_main, "--fix", "--no-baseline", str(tmp_path / "ref" / "mod.py"))
    assert port[0] == ref[0] == 1  # the unregistered 42 stays a finding
    fixed = (tmp_path / "port" / "mod.py").read_text()
    assert "from mpit_tpu_torch.parallel.pserver import TAG_PARAM" in fixed
    assert fixed.replace("mpit_tpu_torch.", "mpit_tpu.") == (tmp_path / "ref" / "mod.py").read_text()
    assert [p.replace(str(tmp_path / "port"), "") for p in port[1:]] == [
        r.replace(str(tmp_path / "ref"), "") for r in ref[1:]]


@pytest.mark.parametrize("argv", [
    ("no/such/path",), ("--only", "MPT999"), ("conform", "no/such/dir"),
])
def test_usage_errors_exit_2_as_the_reference(argv):
    port, ref = _both(*argv)
    assert port[0] == ref[0] == 2
    assert re.sub(r"mpit_tpu_torch\b", "mpit_tpu", port[2]) == ref[2]


def test_list_rules_prints_the_references_ids():
    port, ref = _both("--list-rules")
    assert [ln.split()[0] for ln in port[1].splitlines()] == [
        ln.split()[0] for ln in ref[1].splitlines()] == [f"MPT{i:03d}" for i in range(1, 23)]
