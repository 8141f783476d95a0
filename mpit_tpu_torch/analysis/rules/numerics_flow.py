"""MPT020-022: precision-flow rules over the numerics model
(:mod:`mpit_tpu_torch.analysis.numerics`, ``project.numerics``).

MPT020 flags an accumulation (``sum``/``mean``/``psum``/...) whose
operand the dataflow proves to be quantized CODES — raw wire
representation, not values. Summing int8 codes adds scaled integers
without their scales; summing bf16 code halves adds uint16 bit patterns.
Both paths must dequantize (or explicitly ``astype(float32)`` + scale)
first: the collectives' f32-accumulate invariant.

MPT021 flags a lossy quantize on the training push/exchange path (its
codes provably reach a ``send``/collective wire hop) whose residual
``x - dequantize(quantize(x))`` is never folded back into error-feedback
state — here, or in the one caller level the model tracks. Without the
fold the quantization error is *dropped* every round instead of
re-injected, which turns an unbiased compressor into a biased one (see
docs/WIRE.md). Deliberately stateless paths (serving weight pushes, the
ZeRO scatter) carry an explicit ``# mpit-analysis: ef-off[reason]``
marker on the quantize line: the design decision is an annotation in the
code, not a baseline entry.

MPT022 flags mode/scale provenance mismatches: int8 codes reaching a
dequant declared bf16 (or vice versa), an int8 dequant whose scale is
``None`` (dropped) or provably from a *different* quantize site
(reused), and a wire tag whose inferred payload precision drifts from
the ``precision`` column in ``wire-schema.lock.json``.

All three inherit the model's resolve-or-skip discipline: an unresolved
mode, a multi-origin value, or an escape into unmodeled code produces no
claim. The dynamic complement is RT104 (``MPIT_RT_NUMERICS=1``).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, List, Optional

from mpit_tpu_torch.analysis.findings import Finding

RULES = {
    "MPT020": (
        "accumulation over quantized codes",
        "a sum/mean/psum reduces bf16/int8 wire codes instead of "
        "dequantized f32 values — bit patterns and unscaled integers "
        "accumulate, silently producing garbage gradients",
    ),
    "MPT021": (
        "unpaired error feedback on a lossy push path",
        "a quantize whose codes reach the wire never folds its residual "
        "x - dequantize(quantize(x)) back into EF state — the "
        "compression error is dropped every round, biasing the update "
        "(mark intentional paths with '# mpit-analysis: ef-off[reason]')",
    ),
    "MPT022": (
        "quantization mode/scale provenance mismatch",
        "codes are dequantized with a mode or scale they were not built "
        "with (or a wire tag's precision drifts from the lockfile) — "
        "the reconstruction is numerically unrelated to the input",
    ),
}


def _emit(by_rel, rule, site, message) -> Optional[Finding]:
    mod = by_rel.get(site.rel)
    if mod is None:
        return None
    anchor = ast.Pass()
    anchor.lineno = site.line
    anchor.col_offset = site.col
    f = mod.finding(rule, anchor, message)
    return dataclasses.replace(f, symbol=site.symbol)


def _mpt020(model, by_rel) -> Iterable[Finding]:
    for r in model.reduce_sites:
        f = _emit(
            by_rel,
            "MPT020",
            r.site,
            f"{r.func}() accumulates {r.operand} — raw wire codes, not "
            "values; reduce over the f32 reconstruction (dequantize "
            "first), never over the wire representation",
        )
        if f is not None:
            yield f


def _mpt021(model, by_rel) -> Iterable[Finding]:
    for q in model.quant_sites:
        if q.ef != "unpaired":
            # paired, ef-off-marked, purely local, or escaping into
            # unmodeled code (no claim) — only a proven sent-and-never-
            # folded site is a finding
            continue
        f = _emit(
            by_rel,
            "MPT021",
            q.site,
            f"{q.func}({q.mode or '?'}) codes reach the wire but the "
            "residual x - dequantize(quantize(x)) is never folded into "
            "error-feedback state — the compression error is dropped "
            "every round (pair it, or mark the site "
            "'# mpit-analysis: ef-off[reason]' if statelessness is the "
            "design)",
        )
        if f is not None:
            yield f


def _mpt022(model, by_rel) -> Iterable[Finding]:
    for d in model.dequant_sites:
        if (
            d.declared_mode is not None
            and d.codes_mode is not None
            and d.declared_mode != d.codes_mode
        ):
            f = _emit(
                by_rel,
                "MPT022",
                d.site,
                f"{d.func}() declares mode {d.declared_mode!r} but its "
                f"codes were built by a {d.codes_mode!r} quantize at "
                f"{d.codes_origin.short() if d.codes_origin else '?'} — "
                "the reconstruction decodes the wrong representation",
            )
            if f is not None:
                yield f
            continue  # one claim per site: the mode confusion subsumes
            # whatever the scale argument looks like
        if d.codes_mode == "int8" and d.scale_is_none:
            f = _emit(
                by_rel,
                "MPT022",
                d.site,
                f"{d.func}() drops the scale (None) for int8 codes "
                f"built at "
                f"{d.codes_origin.short() if d.codes_origin else '?'} — "
                "int8 reconstruction without its absmax scale is "
                "meaningless",
            )
            if f is not None:
                yield f
            continue
        if d.scale_origin is not None and d.codes_origin is not None:
            f = _emit(
                by_rel,
                "MPT022",
                d.site,
                f"{d.func}() pairs codes from "
                f"{d.codes_origin.short()} with a scale from "
                f"{d.scale_origin.short()} — a scale reused across "
                "chunks reconstructs with the wrong magnitude",
            )
            if f is not None:
                yield f
    for tag, ent in sorted(model.tag_precision.items()):
        if ent["site"] is None or ent["locked"] is None:
            continue
        if ent["inferred"] == ent["locked"]:
            continue
        f = _emit(
            by_rel,
            "MPT022",
            ent["site"],
            f"{ent['name']} payload precision drifted: senders now "
            f"carry {ent['inferred'] or ['(none)']} but "
            f"wire-schema.lock.json pins {ent['locked'] or ['(none)']} "
            "— update the lock (schema --update-lock) if the precision "
            "change is intended",
        )
        if f is not None:
            yield f


def run(project) -> Iterable[Finding]:
    model = project.numerics
    by_rel = {m.rel: m for m in project.modules}
    out: List[Finding] = []
    out.extend(_mpt020(model, by_rel))
    out.extend(_mpt021(model, by_rel))
    out.extend(_mpt022(model, by_rel))
    return out
