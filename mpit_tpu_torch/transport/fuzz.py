"""Differential fuzz harness for the structural wire codec (stdlib PRNG).

A copy of ``mpit_tpu/transport/fuzz.py``: the same seeded payloads and
mutations, so :func:`build_corpus` writes the reference's frames and
verdicts, and :func:`replay_corpus` re-verifies the frozen corpus
(``tests/fixtures/wire_corpus/corpus.jsonl``) through the port's decoder.
Three properties:

1. **roundtrip**: every payload of the structural grammar encodes with
   :func:`~mpit_tpu_torch.transport.wire.encode_frame` and decodes back
   bit-equal (floats by their IEEE bytes, so NaN equals itself);
2. **differential**: the framed decode equals a pickle round trip of the
   same ``(src, tag, payload)``;
3. **mutation**: a corrupted frame (preamble and header bit flips, CRC and
   length surgery, truncations, appends, future versions) raises
   :class:`~mpit_tpu_torch.transport.wire.WireDecodeError` or decodes to
   the original value, never to another value, a crash or a hang. Body
   content is never flipped: the CRC covers the header only.

The corpus's pickles were written by the reference and name its
``QuantArray``; they are read with :func:`wire.loads`, which maps that
name to the port's class without importing the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import random
import struct
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from mpit_tpu_torch.quant import QuantArray, quantize
from mpit_tpu_torch.transport import wire
from mpit_tpu_torch.transport.socket_transport import WIRE_PICKLE_PROTOCOL
from mpit_tpu_torch.transport.wire import (
    PREAMBLE_SIZE,
    WIRE_FORMAT_VERSION,
    WireDecodeError,
)

#: dtypes the codec registers — the generator covers every one
_ARRAY_DTYPES = (
    np.float32,
    np.float64,
    np.int64,
    np.int32,
    np.int8,
    np.uint8,
    np.uint16,
    np.bool_,
    np.int16,
    np.uint32,
    np.uint64,
    np.float16,
)

#: preamble layout (">2sBBII"): magic 0:2, version 2, flags 3,
#: header-len 4:8, header-crc 8:12
_VERSION_OFF = 2
_HLEN_OFF = 4
_HCRC_OFF = 8
_U32 = struct.Struct(">I")


# ---------------------------------------------------------------------------
# framing helpers


def frame_bytes(src: int, tag: int, payload: Any) -> Optional[bytes]:
    """One contiguous wire frame, or None when the payload is not
    structural (the transport would pickle it)."""
    bufs = wire.encode_frame(
        src, tag, payload, version=WIRE_FORMAT_VERSION
    )
    if bufs is None:
        return None
    return b"".join(bytes(b) for b in bufs)


def decode_bytes(data: bytes) -> Tuple[int, int, Any]:
    """Decode one contiguous frame the way the transport does: split the
    preamble, slice the header, hand the rest over as the body. Any
    malformation raises :class:`WireDecodeError`."""
    if len(data) < PREAMBLE_SIZE:
        raise WireDecodeError("short preamble")
    version, flags, hlen, hcrc = wire.split_preamble(
        data[:PREAMBLE_SIZE]
    )
    header_end = PREAMBLE_SIZE + hlen
    if header_end > len(data):
        raise WireDecodeError("truncated header")
    header = data[PREAMBLE_SIZE:header_end]
    return wire.decode_frame(flags, hcrc, header, data[header_end:])


def deep_equal(a: Any, b: Any) -> bool:
    """Bit-exact structural equality: floats by their packed IEEE bytes
    (NaN equals NaN), arrays by dtype+shape+raw bytes, QuantArrays by
    mode + f32-packed scale (the wire stores f32; the pickle path keeps
    f64 — both pack to the same f32) + data."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return struct.pack("!d", a) == struct.pack("!d", b)
    if isinstance(a, np.ndarray):
        return (
            a.dtype == b.dtype
            and a.shape == b.shape
            and a.tobytes() == b.tobytes()
        )
    if isinstance(a, QuantArray):
        return (
            a.mode == b.mode
            and struct.pack("!f", a.scale) == struct.pack("!f", b.scale)
            and deep_equal(a.data, b.data)
        )
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(
            deep_equal(x, y) for x, y in zip(a, b)
        )
    return a == b


# ---------------------------------------------------------------------------
# payload generation (seeded, stdlib random only)


def _gen_int(rng: random.Random) -> int:
    kind = rng.randrange(6)
    if kind == 0:
        return rng.randrange(-8, 64)
    if kind == 1:
        return rng.randrange(1 << 31, 1 << 32)
    if kind == 2:
        return (1 << 63) - rng.randrange(4)  # u64 boundary
    if kind == 3:
        return -(1 << 63) + rng.randrange(4)
    if kind == 4:
        return rng.getrandbits(100)  # wider than any machine word
    return -rng.getrandbits(80)


def _gen_float(rng: random.Random) -> float:
    return rng.choice(
        (
            0.0,
            -0.0,
            1.5,
            -2.25e300,
            float("inf"),
            float("-inf"),
            float("nan"),
            rng.random() * 1e6,
        )
    )


def _gen_str(rng: random.Random) -> str:
    out = []
    for _ in range(rng.randrange(12)):
        cp = rng.randrange(0x110000)
        if 0xD800 <= cp <= 0xDFFF:
            cp = 0x20  # lone surrogates don't utf-8 encode
        out.append(chr(cp))
    return "".join(out)


def _gen_array(rng: random.Random, max_elems: int = 32) -> np.ndarray:
    dtype = np.dtype(rng.choice(_ARRAY_DTYPES))
    ndim = rng.randrange(1, 4)
    shape = []
    elems = 1
    for _ in range(ndim):
        d = rng.randrange(0, 5)
        shape.append(d)
        elems *= d
    if elems > max_elems:
        shape = [rng.randrange(0, max_elems + 1)]
        elems = shape[0]
    raw = rng.randbytes(elems * dtype.itemsize)
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def _gen_quant(rng: random.Random) -> QuantArray:
    n = rng.randrange(1, 17)
    # finite inputs only: int16 bytes widened to f32 (quantize of
    # NaN/inf would be numerically undefined, not a codec property)
    vals = np.frombuffer(rng.randbytes(2 * n), dtype=np.int16)
    return quantize(
        vals.astype(np.float32), rng.choice(("bf16", "int8"))
    )


def _gen_scalar(rng: random.Random) -> Any:
    kind = rng.randrange(8)
    if kind == 0:
        return None
    if kind == 1:
        return rng.choice((True, False))
    if kind == 2:
        return _gen_int(rng)
    if kind == 3:
        return _gen_float(rng)
    if kind == 4:
        return _gen_str(rng)
    if kind == 5:
        return rng.randbytes(rng.randrange(24))
    if kind == 6:
        return _gen_array(rng)
    return _gen_quant(rng)


def gen_payload(rng: random.Random, depth: int = 0) -> Any:
    """One payload from the structural grammar, weighted toward the
    protocol's real envelope shapes."""
    kind = rng.randrange(10)
    if kind < 4 or depth >= 2:
        return _gen_scalar(rng)
    if kind < 6:
        # the push/param envelope idiom: small int header + chunk
        chunk = _gen_quant(rng) if rng.randrange(2) else _gen_array(rng)
        n = rng.randrange(2, 5)
        return tuple(
            [rng.randrange(1 << 32) for _ in range(n - 1)] + [chunk]
        )
    if kind < 8:
        return tuple(
            gen_payload(rng, depth + 1)
            for _ in range(rng.randrange(0, 5))
        )
    return [_gen_scalar(rng) for _ in range(rng.randrange(0, 5))]


# ---------------------------------------------------------------------------
# mutations (preamble/header/length surgery — never body content: the
# CRC covers the header only, body bits ride the TCP checksum by design)


def _header_end(data: bytes) -> int:
    hlen = _U32.unpack_from(data, _HLEN_OFF)[0]
    return min(len(data), PREAMBLE_SIZE + hlen)


def _mut_truncate(data: bytes, rng: random.Random) -> bytes:
    return data[: rng.randrange(len(data))]


def _mut_append(data: bytes, rng: random.Random) -> bytes:
    return data + rng.randbytes(rng.randrange(1, 17))


def _mut_flip_preamble(data: bytes, rng: random.Random) -> bytes:
    i = rng.randrange(PREAMBLE_SIZE)
    out = bytearray(data)
    out[i] ^= 1 << rng.randrange(8)
    return bytes(out)


def _mut_flip_header(data: bytes, rng: random.Random) -> bytes:
    end = _header_end(data)
    if end <= PREAMBLE_SIZE:
        return _mut_flip_preamble(data, rng)  # headerless frame
    i = rng.randrange(PREAMBLE_SIZE, end)
    out = bytearray(data)
    out[i] ^= 1 << rng.randrange(8)
    return bytes(out)


def _mut_crc_xor(data: bytes, rng: random.Random) -> bytes:
    out = bytearray(data)
    out[_HCRC_OFF + rng.randrange(4)] ^= rng.randrange(1, 256)
    return bytes(out)


def _mut_version_bump(data: bytes, rng: random.Random) -> bytes:
    out = bytearray(data)
    out[_VERSION_OFF] = rng.randrange(WIRE_FORMAT_VERSION + 1, 256)
    return bytes(out)


def _mut_magic(data: bytes, rng: random.Random) -> bytes:
    out = bytearray(data)
    i = rng.randrange(2)
    out[i] = (out[i] + rng.randrange(1, 256)) % 256
    return bytes(out)


def _mut_hlen_tweak(data: bytes, rng: random.Random) -> bytes:
    hlen = _U32.unpack_from(data, _HLEN_OFF)[0]
    delta = rng.choice((-3, -2, -1, 1, 2, 3, 64, 4096))
    out = bytearray(data)
    _U32.pack_into(out, _HLEN_OFF, max(0, hlen + delta) & 0xFFFFFFFF)
    return bytes(out)


def _mut_swap(data: bytes, rng: random.Random) -> bytes:
    end = _header_end(data)
    if end < 2:
        return _mut_append(data, rng)
    i = rng.randrange(end)
    j = rng.randrange(end)
    out = bytearray(data)
    out[i], out[j] = out[j], out[i]
    return bytes(out)


MUTATIONS: List[Tuple[str, Callable]] = [
    ("truncate", _mut_truncate),
    ("append", _mut_append),
    ("flip_preamble", _mut_flip_preamble),
    ("flip_header", _mut_flip_header),
    ("crc_xor", _mut_crc_xor),
    ("version_bump", _mut_version_bump),
    ("magic", _mut_magic),
    ("hlen_tweak", _mut_hlen_tweak),
    ("swap", _mut_swap),
]


def classify_mutation(
    mutated: bytes, src: int, tag: int, payload: Any
) -> Tuple[str, str]:
    """("error"|"ok"|"wrong"|"crash", detail). The gate contract: a
    mutated frame must raise WireDecodeError or decode EXACTLY to the
    original triple (benign flips) — anything else is a codec bug."""
    try:
        msrc, mtag, mpayload = decode_bytes(mutated)
    except WireDecodeError:
        return "error", ""
    except Exception as e:  # an uncaught exception class IS the bug
        return "crash", repr(e)
    if msrc == src and mtag == tag and deep_equal(mpayload, payload):
        return "ok", ""
    return "wrong", (
        f"decoded ({msrc!r}, {mtag!r}, {type(mpayload).__name__}) "
        f"!= original ({src!r}, {tag!r}, {type(payload).__name__})"
    )


# ---------------------------------------------------------------------------
# the gate


@dataclasses.dataclass
class FuzzReport:
    seed: int = 0
    examples: int = 0
    roundtrip_ok: int = 0
    differential_ok: int = 0
    mutations_error: int = 0
    mutations_benign: int = 0
    corpus_clean: int = 0
    corpus_mutations: int = 0
    failures: List[str] = dataclasses.field(default_factory=list)

    def merge(self, other: "FuzzReport") -> None:
        self.examples += other.examples
        self.roundtrip_ok += other.roundtrip_ok
        self.differential_ok += other.differential_ok
        self.mutations_error += other.mutations_error
        self.mutations_benign += other.mutations_benign
        self.corpus_clean += other.corpus_clean
        self.corpus_mutations += other.corpus_mutations
        self.failures.extend(other.failures)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        status = "FAIL" if self.failures else "ok"
        return (
            f"fuzz gate {status}: {self.examples} example(s) "
            f"(seed {self.seed}): {self.roundtrip_ok} roundtrip, "
            f"{self.differential_ok} differential, "
            f"{self.mutations_error}+{self.mutations_benign} mutations "
            f"(error+benign), corpus {self.corpus_clean} clean / "
            f"{self.corpus_mutations} mutated, "
            f"{len(self.failures)} failure(s)"
        )


def run_fuzz(seed: int = 0, examples: int = 10000) -> FuzzReport:
    rng = random.Random(seed)
    report = FuzzReport(seed=seed, examples=examples)
    for i in range(examples):
        src = rng.randrange(64)
        tag = rng.randrange(1, 9)
        payload = gen_payload(rng)
        data = frame_bytes(src, tag, payload)
        if data is None:
            report.failures.append(
                f"example {i}: structural payload refused by "
                f"encode_frame ({type(payload).__name__})"
            )
            continue
        try:
            dsrc, dtag, dpayload = decode_bytes(data)
        except Exception as e:
            report.failures.append(
                f"example {i}: clean frame failed decode: {e!r}"
            )
            continue
        if not (
            dsrc == src and dtag == tag and deep_equal(dpayload, payload)
        ):
            report.failures.append(
                f"example {i}: roundtrip inequality "
                f"({type(payload).__name__})"
            )
            continue
        report.roundtrip_ok += 1
        blob = pickle.dumps(
            (src, tag, payload), protocol=WIRE_PICKLE_PROTOCOL
        )
        psrc, ptag, ppayload = wire.loads(blob)
        if not (
            psrc == dsrc and ptag == dtag and deep_equal(dpayload, ppayload)
        ):
            report.failures.append(
                f"example {i}: framed decode != pickle decode "
                f"({type(payload).__name__})"
            )
            continue
        report.differential_ok += 1
        for _ in range(2):
            name, op = MUTATIONS[rng.randrange(len(MUTATIONS))]
            outcome, detail = classify_mutation(
                op(data, rng), src, tag, payload
            )
            if outcome == "error":
                report.mutations_error += 1
            elif outcome == "ok":
                report.mutations_benign += 1
            else:
                report.failures.append(
                    f"example {i}: mutation {name}: {outcome} {detail}"
                )
    return report


# ---------------------------------------------------------------------------
# regression corpus (checked in, replayed as lint gate 9)


def _corpus_payloads(rng: random.Random) -> List[Tuple[int, int, Any]]:
    """A fixed showcase of grammar corners plus generated envelopes."""
    fixed: List[Any] = [
        None,
        True,
        False,
        0,
        -1,
        (1 << 63) - 1,
        -(1 << 63),
        1 << 100,
        0.0,
        float("nan"),
        float("inf"),
        "",
        "päylöad ✓",
        b"",
        b"\x00\xffMW",
        (),
        (0, 1),
        [],
        [1, 2.5, "three", None],
        np.frombuffer(b"", dtype=np.float32),
        np.arange(6, dtype=np.int32).reshape(2, 3),
        quantize(np.arange(8, dtype=np.float32), "int8"),
        quantize(np.arange(8, dtype=np.float32) - 4.0, "bf16"),
        (7, 3, 1, np.ones(4, dtype=np.float32)),
    ]
    out = [
        (i % 8, 1 + i % 8, p) for i, p in enumerate(fixed)
    ]
    while len(out) < 40:
        out.append(
            (rng.randrange(8), rng.randrange(1, 9), gen_payload(rng))
        )
    return out


def build_corpus(seed: int = 0) -> List[dict]:
    rng = random.Random(seed)
    entries: List[dict] = []
    for p_i, (src, tag, payload) in enumerate(_corpus_payloads(rng)):
        data = frame_bytes(src, tag, payload)
        if data is None:
            raise AssertionError(
                f"corpus payload {p_i} is not structural"
            )
        blob = pickle.dumps(
            (src, tag, payload), protocol=WIRE_PICKLE_PROTOCOL
        )
        entries.append(
            {
                "id": f"clean-{p_i:03d}",
                "kind": "clean",
                "op": "",
                "frame": data.hex(),
                "expect": "ok",
                "pickle": blob.hex(),
            }
        )
        for name, op in MUTATIONS:
            mutated = op(data, rng)
            outcome, detail = classify_mutation(
                mutated, src, tag, payload
            )
            if outcome not in ("error", "ok"):
                raise AssertionError(
                    f"corpus payload {p_i} mutation {name}: {outcome} "
                    f"{detail}"
                )
            entries.append(
                {
                    "id": f"mut-{p_i:03d}-{name}",
                    "kind": "mutation",
                    "op": name,
                    "frame": mutated.hex(),
                    "expect": outcome,
                    "pickle": blob.hex(),
                }
            )
    return entries


def write_corpus(path, seed: int = 0) -> int:
    entries = build_corpus(seed=seed)
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e, sort_keys=True) + "\n")
    return len(entries)


def replay_corpus(path) -> FuzzReport:
    """Re-verify every checked-in frame against its recorded verdict.
    Any difference — a clean frame decoding differently, a mutation
    whose outcome changed in EITHER direction — is a failure: codec
    changes must regenerate the corpus consciously."""
    report = FuzzReport()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            e = json.loads(line)
            data = bytes.fromhex(e["frame"])
            src, tag, payload = wire.loads(bytes.fromhex(e["pickle"]))
            if e["kind"] == "clean":
                try:
                    dsrc, dtag, dpayload = decode_bytes(data)
                except Exception as exc:
                    report.failures.append(
                        f"corpus {e['id']}: clean frame failed decode: "
                        f"{exc!r}"
                    )
                    continue
                if not (
                    dsrc == src
                    and dtag == tag
                    and deep_equal(dpayload, payload)
                ):
                    report.failures.append(
                        f"corpus {e['id']}: clean frame no longer "
                        "decodes to its recorded value"
                    )
                    continue
                report.corpus_clean += 1
            else:
                outcome, detail = classify_mutation(
                    data, src, tag, payload
                )
                if outcome != e["expect"]:
                    report.failures.append(
                        f"corpus {e['id']} ({e['op']}): expected "
                        f"{e['expect']}, got {outcome} {detail}"
                    )
                    continue
                report.corpus_mutations += 1
    return report
