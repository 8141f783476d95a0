"""The port's frame codec and fuzz harness against the reference's.

``mpit_tpu_torch/transport/wire.py`` and ``fuzz.py`` are copies of the
reference's, so they are held equal byte for byte: the same seeded
payloads give the same frames, a frame of either package decodes in the
other to an equal value, the preamble and hello helpers agree, and the
frozen corpus replays with its recorded verdicts. The corpus's pickles
name the reference's ``QuantArray``; the port reads them through its
mapped unpickler without importing the JAX package (a subprocess shows
``mpit_tpu`` absent from ``sys.modules``). The static checks of the
reference run on the port: its wire schema equals the lock's for tags
1-10 and the shard snapshot, and lint rule MPT007 finds nothing.
"""

import json
import os
import pickle
import random
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mpit_tpu.analysis import lint
from mpit_tpu.quant import QuantArray as RefQuantArray
from mpit_tpu.transport import fuzz as ref_fuzz
from mpit_tpu.transport import wire as ref_wire
from mpit_tpu.transport.chaos import CorruptedPayload as RefCorrupted
from mpit_tpu.transport.chaos import FaultEvent as RefFaultEvent
from mpit_tpu_torch.quant import QuantArray
from mpit_tpu_torch.transport import fuzz, wire
from mpit_tpu_torch.transport.base import CorruptedPayload

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "fixtures" / "wire_corpus" / "corpus.jsonl"


def _plain(v):
    """A payload of either package as plain values, for equality across
    packages: arrays by (dtype, shape, bytes), floats by their bytes,
    QuantArrays by (mode, f32 scale bytes, data)."""
    if isinstance(v, (QuantArray, RefQuantArray)):
        return ("quant", v.mode, struct.pack("!f", v.scale), _plain(v.data))
    if isinstance(v, (CorruptedPayload, RefCorrupted)):
        return ("corrupt", v.src, v.dst, v.tag, v.n)
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, float):
        return ("f", struct.pack("!d", v))
    if isinstance(v, (tuple, list)):
        return (type(v).__name__, [_plain(x) for x in v])
    return (type(v).__name__, v)


def _draws(seed, n):
    """n seeded ``(src, tag, payload)`` draws from each package's grammar,
    as ``run_fuzz`` draws them."""
    out = []
    for gen in (ref_fuzz.gen_payload, fuzz.gen_payload):
        rng = random.Random(seed)
        out.append([(rng.randrange(64), rng.randrange(1, 9), gen(rng)) for _ in range(n)])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_payloads_give_byte_equal_frames(seed):
    """60 draws per seed (240 in all): the same payloads, and each
    package's encoder writes the same bytes for them."""
    ref, port = _draws(seed, 60)
    for (rs, rt, rp), (ps, pt, pp) in zip(ref, port):
        assert (rs, rt, _plain(rp)) == (ps, pt, _plain(pp))
        assert fuzz.frame_bytes(ps, pt, pp) == ref_fuzz.frame_bytes(rs, rt, rp)


def test_corpus_payloads_give_byte_equal_frames():
    ref = ref_fuzz._corpus_payloads(random.Random(0))
    port = fuzz._corpus_payloads(random.Random(0))
    assert len(ref) == len(port) == 40
    for (rs, rt, rp), (ps, pt, pp) in zip(ref, port):
        assert _plain(rp) == _plain(pp)
        assert fuzz.frame_bytes(ps, pt, pp) == ref_fuzz.frame_bytes(rs, rt, rp)


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_frames_decode_across_packages(direction):
    """A frame written by one package decodes in the other to an equal
    value, arrays as views into the frame."""
    ref, port = _draws(11, 80)
    for (rs, rt, rp), (ps, pt, pp) in zip(ref, port):
        if direction == "ref-to-port":
            got = fuzz.decode_bytes(ref_fuzz.frame_bytes(rs, rt, rp))
            want = (ps, pt, pp)
            assert fuzz.deep_equal(got[2], pp)
        else:
            got = ref_fuzz.decode_bytes(fuzz.frame_bytes(ps, pt, pp))
            want = (rs, rt, rp)
            assert ref_fuzz.deep_equal(got[2], rp)
        assert _plain(got) == _plain(want)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (ref_wire.WireDecodeError, wire.WireDecodeError) as e:
        return ("error", str(e), e.src, e.tag)


def test_hello_and_preamble_helpers_agree():
    rng = random.Random(5)
    hellos = [wire.encode_hello(), wire.encode_hello(0), wire.encode_hello(7), b"MWH",
              b"MWX\x01", b"XWH\x01", b""] + [rng.randbytes(4) for _ in range(50)]
    assert wire.encode_hello() == ref_wire.encode_hello()
    assert [wire.decode_hello(h) for h in hellos] == [ref_wire.decode_hello(h) for h in hellos]
    frame = fuzz.frame_bytes(3, 4, (1, np.arange(3, dtype=np.float32)))
    preambles = [frame[: wire.PREAMBLE_SIZE], frame[:5]] + [
        fuzz.MUTATIONS[rng.randrange(len(fuzz.MUTATIONS))][1](frame, rng)[: wire.PREAMBLE_SIZE]
        for _ in range(200)
    ]
    for p in preambles:
        assert _outcome(wire.split_preamble, p) == _outcome(ref_wire.split_preamble, p)


def test_decode_verdicts_agree_on_mutated_frames():
    """The same mutated frames get the same verdict, and the same
    message and stream coordinates on an error, in both decoders."""
    rng = random.Random(9)
    ref, _ = _draws(12, 60)
    for s, t, p in ref:
        data = ref_fuzz.frame_bytes(s, t, p)
        for _name, op in fuzz.MUTATIONS:
            m = op(data, rng)
            got, want = _outcome(fuzz.decode_bytes, m), _outcome(ref_fuzz.decode_bytes, m)
            assert got[0] == want[0]
            if got[0] == "error":
                assert got == want
            else:
                assert _plain(got[1]) == _plain(want[1])


def test_the_frozen_corpus_replays_with_its_verdicts():
    report = fuzz.replay_corpus(CORPUS)
    assert report.failures == []
    assert (report.corpus_clean, report.corpus_mutations) == (40, 360)


def test_build_corpus_equals_the_frozen_file():
    """Every frame and verdict of the port's ``build_corpus(0)`` equals the
    file's; the pickles differ only by the class path they name, so they
    are equal by value after the mapped unpickling."""
    frozen = [json.loads(line) for line in CORPUS.read_text().splitlines() if line.strip()]
    built = fuzz.build_corpus(0)
    assert len(built) == len(frozen) == 400
    for b, f in zip(built, frozen):
        assert {k: b[k] for k in ("id", "kind", "op", "frame", "expect")} == {
            k: f[k] for k in ("id", "kind", "op", "frame", "expect")}
        assert _plain(wire.loads(bytes.fromhex(b["pickle"]))) == _plain(
            wire.loads(bytes.fromhex(f["pickle"])))


@pytest.mark.parametrize("seed", [0, 7])
def test_run_fuzz_matches_the_reference(seed):
    got, want = fuzz.run_fuzz(seed, examples=300), ref_fuzz.run_fuzz(seed, examples=300)
    assert got.failures == [] and want.failures == []
    assert got.to_json() == want.to_json()


def test_mapped_unpickler_maps_the_reference_classes_and_refuses_others():
    q = pickle.dumps((1, 2, RefQuantArray("int8", 0.5, np.arange(4, dtype=np.int8))), protocol=5)
    got = wire.loads(q)
    assert type(got[2]) is QuantArray and got[2].scale == 0.5
    np.testing.assert_array_equal(got[2].data, np.arange(4, dtype=np.int8))
    c = wire.loads(pickle.dumps(RefCorrupted(1, 2, 3, 4), protocol=5))
    assert c == CorruptedPayload(1, 2, 3, 4)
    with pytest.raises(wire.WireDecodeError, match="mpit_tpu.transport.chaos.FaultEvent"):
        wire.loads(pickle.dumps(RefFaultEvent("drop", 0, 1, 2, 3), protocol=5))
    # the port's own pickles read back as they are
    own = (QuantArray("bf16", 1.0, np.arange(3, dtype=np.uint16)), CorruptedPayload(5))
    assert _plain(wire.loads(pickle.dumps(own, protocol=5))) == _plain(own)


_NO_REFERENCE = """
import pickle, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from mpit_tpu_torch.transport import fuzz, wire
report = fuzz.replay_corpus(Path({corpus!r}))
assert report.failures == [] and report.corpus_clean == 40, report.summary()
q = wire.loads(bytes.fromhex({blob!r}))
assert type(q[2]).__module__ == "mpit_tpu_torch.quant", type(q[2])
leaked = sorted(m for m in sys.modules if m == "mpit_tpu" or m.startswith("mpit_tpu."))
assert not leaked and "jax" not in sys.modules, leaked
print("clean")
"""


def test_decoding_reference_pickles_never_imports_the_reference():
    blob = pickle.dumps(
        (1, 2, RefQuantArray("bf16", 1.0, np.arange(5, dtype=np.uint16))), protocol=5).hex()
    code = _NO_REFERENCE.format(repo=str(REPO), corpus=str(CORPUS), blob=blob)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=str(REPO / "tests"), env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def _project():
    modules = []
    for ap, rel in lint.collect_files([REPO / "mpit_tpu_torch"]):
        ctx = lint.load_module(ap, rel)
        if ctx is not None:
            modules.append(ctx)
    return lint.Project(modules=modules, config=lint.Config())


def test_port_wire_schema_equals_the_lock_for_its_tags_and_snapshot():
    """Tags 1-10 (the PS protocol) and the shard snapshot's keys are
    inferred from the port as the lock has them; tags 11-15 are the
    fleet's (ROADMAP.md item A10)."""
    doc = _project().schema.to_json()
    lock = json.loads((REPO / "wire-schema.lock.json").read_text())
    assert sorted(doc["tags"], key=int) == [str(t) for t in range(1, 11)]
    assert {t: doc["tags"][t] for t in doc["tags"]} == {t: lock["tags"][t] for t in doc["tags"]}
    assert doc["snapshot"] == lock["snapshot"]
    assert doc["snapshot"]["writes"] == [
        "center", "dedup", "gen", "membership", "ring", "shards", "version"]


def test_every_frame_writer_of_the_port_pins_the_wire_versions():
    """Lint rule MPT007: every ``encode_frame`` pins WIRE_FORMAT_VERSION
    and every wire ``pickle.dumps`` WIRE_PICKLE_PROTOCOL, by name."""
    findings = lint.run_lint([REPO / "mpit_tpu_torch"], lint.Config(only_rules=["MPT007"]))
    assert findings == []
