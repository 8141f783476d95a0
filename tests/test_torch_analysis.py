"""The port's static analyzer (``mpit_tpu_torch.analysis``): its core and
rules against the reference's (``mpit_tpu.analysis``).

- the reference's seeded fixtures (``tests/fixtures/analysis/``) give both
  analyzers the same findings, except the JAX-idiom fixtures of the four
  retargeted families (MPT001, MPT004, MPT020, MPT022), which the port
  cannot contain: there the port is held to torch twins of them, written
  line for line, which it flags at the reference's rule and line, and to
  clean twins it passes;
- the port's own package, scanned once by ``python -m
  mpit_tpu_torch.analysis`` in a process that refuses to import JAX and
  the reference package, exits 0 against the port's baseline, and its
  protocol-half findings (every rule but MPT001, MPT004, MPT005 and
  MPT020-022) are the reference analyzer's on the same files, finding for
  finding.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import pytest

from mpit_tpu.analysis import lint as ref_lint
from mpit_tpu.analysis.rules import RULE_DOCS as REF_RULE_DOCS
from mpit_tpu_torch.analysis import findings as findings_mod
from mpit_tpu_torch.analysis import lint
from mpit_tpu_torch.analysis.findings import Finding
from mpit_tpu_torch.analysis.rules import RULE_DOCS

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mpit_tpu_torch"
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "analysis"
DEVICE_RULES = {"MPT001", "MPT004", "MPT005", "MPT020", "MPT021", "MPT022"}
# the reference's fixtures in a JAX idiom the port cannot contain
JAX_IDIOM = {"fixture_mpt001.py", "fixture_mpt004.py", "fixture_mpt004_chain",
             "fixture_mpt020.py", "fixture_mpt022.py"}
# MPT003/MPT007/MPT012 name the canonical registry, wire constant or live
# module in their message: each analyzer names its own package (and file
# and line)
_CANON = re.compile(r"\((mpit_tpu(?:_torch)?/[^)]*)\)")

CLI_SCRIPT = r"""
import json, sys
FORBIDDEN = ("jax", "jaxlib", "mpit_tpu")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"{name} refused")
        return None


sys.meta_path.insert(0, Refuse())
from mpit_tpu_torch.analysis import __main__ as cli, lint

seen = []
run_lint = lint.run_lint


def recording(paths, config=None):
    seen.extend(run_lint(paths, config))
    return list(seen)


lint.run_lint = recording
rc = cli.main(sys.argv[1:])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
print(json.dumps({"rc": rc, "leaked": leaked, "all": [f.to_dict() for f in seen]}))
"""


def _key(f, canon=False):
    msg = f.message
    if canon:
        msg = _CANON.sub("(<canonical>)", re.sub(r"\bmpit_tpu_torch\b", "mpit_tpu", msg))
    return (f.rule, f.path, f.line, f.col, f.symbol, msg)


@pytest.fixture(scope="module")
def port_cli_scan():
    """``python -m mpit_tpu_torch.analysis --json`` over the package, as a
    user runs it, with JAX and ``mpit_tpu`` refused; every finding the
    scan made is recorded beside the CLI's own output."""
    proc = subprocess.run([sys.executable, "-c", CLI_SCRIPT, "--json"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    *body, last = proc.stdout.strip().splitlines()
    return proc.returncode, json.loads("\n".join(body)), json.loads(last), proc.stderr


@pytest.fixture(scope="module")
def ref_scan():
    return ref_lint.run_lint([PKG])


def test_the_cli_stands_without_jax_and_passes_the_ports_baseline(port_cli_scan):
    rc, doc, rec, err = port_cli_scan
    assert rec["rc"] == 0 and rc == 0, err
    assert rec["leaked"] == []
    assert doc["findings"] == []
    assert doc["total_scanned"] == doc["baselined"] == len(rec["all"]) > 0
    # the baseline is the port's own, and none of it is stale
    assert lint.default_baseline_path(PKG) == PKG / "analysis" / "baseline.json"
    baseline = findings_mod.load_baseline(lint.default_baseline_path(PKG))
    current = Counter(Finding(**f).fingerprint for f in rec["all"])
    assert current == baseline


def test_protocol_half_findings_equal_the_references_on_the_port(port_cli_scan, ref_scan):
    port = [Finding(**f) for f in port_cli_scan[2]["all"]]
    got = [_key(f) + (f.text,) for f in port if f.rule not in DEVICE_RULES]
    want = [_key(f) + (f.text,) for f in ref_scan if f.rule not in DEVICE_RULES]
    assert got == want and len(got) >= 14
    # the device rules' findings are the reference's retargeted: the same
    # host syncs it reports (read as the port writes them; the fit loop's
    # loss line among them), and no unguarded axis name (the pipeline takes
    # its batch axis by position, as the reference does)
    dev = Counter(f.rule for f in port if f.rule in DEVICE_RULES)
    assert dev == {"MPT005": 12}


def test_rule_table_keeps_the_references_ids():
    assert sorted(RULE_DOCS) == sorted(REF_RULE_DOCS) == [f"MPT{i:03d}" for i in range(1, 23)]


@pytest.mark.parametrize("fixture", sorted(
    p.name for p in FIXTURES.iterdir()
    if p.name.startswith("fixture_") and p.name not in JAX_IDIOM) + ["../graph_pkg"])
def test_reference_fixtures_give_both_analyzers_the_same_findings(fixture, tmp_path):
    """The same files, read by each analyzer in its own namespace: the
    port's copy names ``mpit_tpu_torch`` where the fixture imports
    ``mpit_tpu`` (the same lines otherwise)."""
    src = FIXTURES / fixture
    dst = tmp_path / src.name
    files = [src] if src.is_file() else sorted(src.rglob("*.py"))
    for f in files:
        out = dst if src.is_file() else dst / f.relative_to(src)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(re.sub(r"\bmpit_tpu\b", "mpit_tpu_torch", f.read_text()))
    want = [_key(f, True) for f in ref_lint.run_lint([src], ref_lint.Config(hot_all=True))]
    got = [_key(f, True) for f in lint.run_lint([dst], lint.Config(hot_all=True))]
    assert got == want
    assert want or fixture == "../graph_pkg"


# ------------------------------------------------------------- torch twins

HEADER = '"""Torch twin of {name}.\n\nParsed by the linter tests, never imported.\n"""\n'

# (family, the reference's fixture whose finding the twin mirrors or None,
#  twin source, clean source); the flagged line carries "# BUG"
TWINS = {
    "mpt001-axis-span": ("fixture_mpt001.py", """
        import torch


        def bad_span(topo):
            # "rows" is never bound by any axis_names/Topology/P context here
            return topo.axis_span("rows")  # BUG
        """, """
        import torch


        def span(topo):
            names = topo.axis_names
            if names[0] != "rows":
                raise ValueError(names)
            return topo.axis_span("rows")
        """),
    "mpt001-ppermute-ring": (None, """
        from mpit_tpu_torch.comm.collectives import ppermute_ring


        def hop(x):
            return ppermute_ring(x, 1, "sp")  # BUG
        """, """
        import mpit_tpu_torch
        from mpit_tpu_torch.comm.collectives import ppermute_ring


        def hop(x):
            mpit_tpu_torch.init(axis_names=("dp", "sp"), mesh_shape=(2, 4))
            return ppermute_ring(x, 1, "sp")
        """),
    "mpt004-vmap": ("fixture_mpt004.py", '''
        """Seeded MPT004: vmap in_dims drifted off the wrapped signature.

        The function lost a parameter but its wrapper still maps three
        arguments. This file is parsed by the linter tests, never imported
        or executed.
        """

        import functools

        import torch


        @functools.partial(torch.func.vmap, in_dims=(None, 0, 0))  # BUG
        def step(model, batch):
            return model, batch
        ''', '''
        import functools

        import torch


        @functools.partial(torch.func.vmap, in_dims=(None, 0))
        def step(model, batch):
            return model, batch


        def grads(loss_fn):
            def vg(params, x, y):
                return loss_fn(params, x, y)
            return torch.func.vmap(vg, in_dims=(None, 0, 0))
        '''),
    "mpt004-autograd-backward": (None, """
        import torch


        class Scale(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, factor, bias):
                ctx.factor = factor
                return x * factor + bias

            @staticmethod
            def backward(ctx, g):
                return g * ctx.factor, None  # BUG
        """, """
        import torch
        from torch.autograd import Function


        class Scale(Function):
            @staticmethod
            def forward(x, factor, bias):
                return x * factor + bias

            @staticmethod
            def setup_context(ctx, inputs, output):
                ctx.factor = inputs[1]

            @staticmethod
            def backward(ctx, g):
                return g * ctx.factor, None, g
        """),
    "mpt005-cpu": ("fixture_mpt005.py", '''
        """Seeded MPT005: host-device copy inside a loop (linted as hot path).

        This file is parsed by the linter tests (with ``Config(hot_all=True)``),
        never imported or executed.
        """


        def train(step_fn, batches):
            total = 0.0
            for batch in batches:
                loss = step_fn(batch)
                total += loss.cpu()  # BUG
            return total
        ''', """
        from mpit_tpu_torch.utils.profiling import force_completion


        def settle(t):  # mpit-analysis: host-sync-barrier
            return t.cpu().numpy()


        def train(step_fn, batches):
            out = []
            for batch in batches:
                loss = step_fn(batch)
                force_completion(loss.cpu())
                out.append(settle(loss))
            return out
        """),
    "mpt005-tolist": (None, """
        def train(step_fn, batches):
            for batch in batches:
                print(step_fn(batch).tolist())  # BUG
        """, None),
    "mpt005-numpy-once": (None, """
        def train(step_fn, batches):
            out = []
            for b in batches:
                out.append(step_fn(b).cpu().numpy())  # BUG
            return out
        """, None),
    "mpt005-cuda-synchronize": (None, """
        import torch


        def train(step_fn, batches):
            for batch in batches:
                step_fn(batch)
                torch.cuda.synchronize()  # BUG
        """, None),
    "mpt005-event-synchronize": (None, """
        import torch


        def train(step_fn, batches):
            done = torch.cuda.Event()
            while batches:
                step_fn(batches.pop())
                done.record()
                done.synchronize()  # BUG
        """, None),
    "mpt020-method-sum": ("fixture_mpt020.py", '''
        """Seeded: a reduction over quantized codes.

        The block-quantized rows are summed in their wire representation —
        unscaled int8 integers — instead of the f32 reconstruction, so the
        accumulator is garbage whenever rows carry different absmax scales.
        The error-feedback fold is present (the quantize is paired), so MPT021
        must stay quiet: the numerics rule must flag the ``codes.sum`` site
        (MPT020) and nothing else. Parsed by the linter tests, never imported.
        """

        import torch

        from mpit_tpu_torch.quant import dequantize_rows_torch, quantize_rows_torch


        def reduce_blocks(rows, mode):
            codes, scales = quantize_rows_torch(rows, mode)
            deq = dequantize_rows_torch(codes, scales, mode)
            residual = rows - deq  # error feedback: the quantize is paired
            # BUG: accumulates the wire codes, not the f32 reconstruction
            total = codes.sum(0)  # BUG
            return total, residual
        ''', """
        import torch

        from mpit_tpu_torch.quant import dequantize_rows_torch, quantize_rows_torch


        def reduce_blocks(rows, mode):
            codes, scales = quantize_rows_torch(rows, mode)
            deq = dequantize_rows_torch(codes, scales, mode)
            residual = rows - deq
            total = deq.sum(0)
            return total, residual
        """),
    "mpt020-all-reduce": (None, """
        import torch.distributed as dist

        from mpit_tpu_torch import quant


        def exchange(flat):
            codes, scale = quant.quantize_torch(flat, "int8")
            residual = flat - quant.dequantize_torch(codes, scale, "int8")
            dist.all_reduce(codes)  # BUG
            return codes, residual
        """, None),
    "mpt021-encode-helper": (None, """
        import torch
        import torch.distributed as dist

        from mpit_tpu_torch.comm.collectives import quantized_rows_encode


        def push(c, mode):
            codes, scales, sent = quantized_rows_encode(c, mode)  # BUG
            out = torch.empty_like(codes)
            dist.all_to_all_single(out, codes)
            return out
        """, """
        import torch
        import torch.distributed as dist

        from mpit_tpu_torch.comm.collectives import (
            quantized_rows_encode,
            quantized_rows_reduce,
        )


        class Exchange:
            def push(self, c, k, mode):
                codes, scales, sent = quantized_rows_encode(c, mode)
                self.residual = c - sent
                out = torch.empty_like(codes)
                dist.all_to_all_single(out, codes)
                rcodes, rscale, self.residual2[k] = quantized_rows_reduce(
                    out, scales, mode, r2=self.residual2[k])
                dist.all_gather_into_tensor(out, rcodes)
                return out
        """),
    "mpt021-handed-hop": (None, """
        from mpit_tpu_torch.comm.collectives import quantized_rows_encode, quantized_rows_hop1


        class Trainer:
            def step(self, c, mode):
                codes, scales, sent = quantized_rows_encode(c, mode)  # BUG
                self.residual = c
                return self._timed_hop(quantized_rows_hop1, (codes, scales, mode))
        """, None),
    "mpt022-mode": ("fixture_mpt022.py", '''
        """Seeded: codes dequantized with the wrong mode (and no scale).

        The rows are quantized as int8 (codes + per-row absmax scales) but the
        reconstruction declares bf16 — the int8 codes are reinterpreted as
        bf16 bit halves and the scales are dropped on the floor, so the
        "reconstruction" is numerically unrelated to the input. The quantize is
        paired (MPT021 quiet) and nothing reduces codes (MPT020 quiet): the
        numerics rule must flag the dequantize site (MPT022) and nothing else.
        Parsed by the linter tests, never imported.
        """

        from mpit_tpu_torch.quant import dequantize_rows_torch, quantize_rows_torch


        def roundtrip(rows):
            codes, scales = quantize_rows_torch(rows, "int8")
            # BUG: int8 codes decoded as bf16, per-row scales dropped
            deq = dequantize_rows_torch(codes, None, "bf16")  # BUG
            residual = rows - deq
            return residual, scales
        ''', """
        from mpit_tpu_torch.quant import dequantize_rows_torch, quantize_rows_torch


        def roundtrip(rows):
            codes, scales = quantize_rows_torch(rows, "int8")
            deq = dequantize_rows_torch(codes, scales, "int8")
            residual = rows - deq
            return residual, scales
        """),
}


def _twin(tmp_path, name, body):
    src = textwrap.dedent(body).lstrip("\n")
    if not src.startswith('"""'):
        src = HEADER.format(name=name) + "\n" + src
    f = tmp_path / f"{name.replace('-', '_')}.py"
    f.write_text(src)
    bug = [i for i, ln in enumerate(src.splitlines(), 1) if ln.rstrip().endswith("# BUG")]
    return f, bug


@pytest.mark.parametrize("family", sorted(TWINS))
def test_a_torch_twin_is_flagged_at_the_references_rule_and_line(family, tmp_path):
    """The twin's one finding is its family's rule on the line marked
    ``# BUG`` (the reference fixture's line, for a line-for-line twin); its
    clean twin, where there is one, has no finding."""
    fixture, bad, clean = TWINS[family]
    rule = "MPT" + family[3:6]
    f, bug = _twin(tmp_path, family, bad)
    got = [(x.rule, x.line) for x in lint.run_lint([f], lint.Config(hot_all=True))]
    assert got == [(rule, bug[0])]
    if fixture is not None:
        ref = ref_lint.run_lint([FIXTURES / fixture], ref_lint.Config(hot_all=True))
        assert [(x.rule, x.line) for x in ref] == got
    if clean is not None:
        f, _ = _twin(tmp_path, family + "-clean", clean)
        assert lint.run_lint([f], lint.Config(hot_all=True)) == []


def test_the_wrapper_chain_twin_is_followed_across_modules(tmp_path):
    """fixture_mpt004_chain with ``torch.func.vmap`` at the top: the
    partial link shifts the frame, so three in_dims entries overrun the
    two arguments left, reported with the chain's depth; two entries are
    clean."""
    ref = ref_lint.run_lint([FIXTURES / "fixture_mpt004_chain"])
    pkg = tmp_path / "fixture_mpt004_chain"
    pkg.mkdir()
    for f in (FIXTURES / "fixture_mpt004_chain").glob("*.py"):
        (pkg / f.name).write_text(f.read_text())
    top = (pkg / "top.py").read_text()
    (pkg / "top.py").write_text(top.replace("import jax\n", "import torch\n").replace(
        "jax.jit(bound_step, static_argnums=(4,))", "torch.func.vmap(bound_step, in_dims=(0, 0, 0))"))
    got = lint.run_lint([pkg])
    assert [(f.rule, f.path, f.line) for f in got] == [(f.rule, f.path, f.line) for f in ref]
    assert "2 positional parameters (reached through a 3-link wrapper chain)" in got[0].message
    (pkg / "top.py").write_text((pkg / "top.py").read_text().replace("(0, 0, 0)", "(0, None)"))
    assert lint.run_lint([pkg]) == []
