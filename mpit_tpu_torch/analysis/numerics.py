"""Whole-program precision-dataflow model (rules MPT020-022, `numerics` CLI).

The repo moves most of its bytes in reduced precision — quantized PS
pushes, EQuARX-style quantized collectives, quantized fleet weight
streaming — and three invariants keep that correct:

1. **accumulate in f32, never over codes** — a ``sum``/``mean``/
   ``all_reduce`` whose operand is bf16/int8 *codes* (the raw wire
   representation) reduces bit patterns, not values (MPT020);
2. **every lossy training-path quantize pairs with error feedback** —
   the residual ``x - dequantize(quantize(x))`` must be folded back into
   EF state on the same stream, or declared stateless with an explicit
   ``# mpit-analysis: ef-off[reason]`` marker (MPT021);
3. **codes are dequantized with the mode and scale they were built
   with** — int8 codes reaching a bf16 dequant, a dropped scale, a scale
   borrowed from a different quantization, or a wire tag whose payload
   precision drifts from the lockfile's ``precision`` column (MPT022).

This pass tracks a small precision lattice (f32 reconstruction ≥
QuantArray/codes provenance ≥ unknown) through assignments, tuple
unpacking, the shared quant kernels (:mod:`mpit_tpu_torch.quant`, numpy
and torch faces), container construction, slicing/reshape passthroughs,
and collective wire hops. Like the schema pass it is resolve-or-skip: a
value the tracker cannot prove to be codes (or a mode it cannot resolve
to a literal) produces NO claim. Callers see what a same-module function
returns (its codes and reconstructions), so the error-feedback pairing a
helper delegates by returning ``sent`` is checked where its callers fold
``x - sent`` — the ``quantized_rows_encode`` / ``quantized_allreduce``
split; callees summarized earlier in the file carry through chains.

The model is ``mpit_tpu/analysis/numerics.py`` read onto the port's forms:

- kernels: the jnp faces (``quantize_jnp``, ``quantize_rows_jnp`` and
  their dequantizers) give way to the torch faces (``quantize_torch``,
  ``quantize_rows_torch``, ``dequantize_torch``,
  ``dequantize_rows_torch``); the numpy faces stay;
- the phase helpers of ``comm/collectives.py`` are kernels to their
  callers in other modules: ``quantized_rows_encode`` returns ``(codes,
  scales, sent)`` with ``sent`` the reconstruction (pairs when a caller
  folds ``c - sent``), ``quantized_rows_reduce`` re-quantizes and returns
  ``(codes, scales, residual)`` (pairs when the caller keeps the
  residual), ``quantized_rows_decode`` dequantizes;
- reductions: ``all_reduce``, ``reduce_scatter_tensor`` and the port's
  ``_fold_sum`` join ``sum``/``mean``/``psum``; a method reduction
  (``codes.sum(0)``) reduces its receiver;
- wire hops: ``all_to_all_single``, ``all_gather_into_tensor``,
  ``batch_isend_irecv`` and the quantized exchange's hops
  (``quantized_rows_hop1``/``hop2``) replace ``lax``'s
  ``all_to_all``/``psum_scatter``/``ppermute`` (``all_gather`` stays:
  ``torch.distributed`` has one);
- a call handed a wire hop as an argument (the bucketed step's
  ``_timed_hop(quantized_rows_hop1, (codes, scales, mode), ...)``) puts its
  other arguments on the wire;
- upcasts: ``.to(torch.float32)`` and ``.float()`` end codes-ness as
  ``.astype(np.float32)`` does;
- a stateless path through a shared helper (the ZeRO scatter reuses the
  allreduce's encode) is declared by an ``ef-off[reason]`` marker on its
  call into the helper, which then lists as a quantize site of its own.

The dynamic complement is RT104 in :mod:`mpit_tpu_torch.analysis.runtime`.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from typing import Dict, FrozenSet, List, Optional

from mpit_tpu_torch.analysis import astutil

#: quantize kernels by callee last-name: "qarray" returns a QuantArray,
#: "pair" returns (codes, scale[s]), "triple" (codes, scales, the
#: reconstruction sent), "requant" (codes, scales, the EF residual)
QUANT_FNS = {
    "quantize": "qarray",
    "quantize_rows": "pair",
    "quantize_torch": "pair",
    "quantize_rows_torch": "pair",
    "quantized_rows_encode": "triple",
    "quantized_rows_reduce": "requant",
}
#: dequantize kernels: positional index of the declared-mode argument
#: (None = the host face, whose mode rides inside the QuantArray)
DEQUANT_FNS = {
    "dequantize": None,
    "dequantize_rows": 2,
    "dequantize_torch": 2,
    "dequantize_rows_torch": 2,
    "quantized_rows_decode": 2,
}
#: reducers/accumulators MPT020 guards (bare, attribute or method calls)
REDUCE_FNS = (
    "sum",
    "mean",
    "nansum",
    "prod",
    "psum",
    "pmean",
    "all_reduce",
    "reduce_scatter_tensor",
    "_fold_sum",
)
#: calls that put a value on the wire (sends and collective hops) — the
#: "training push/exchange path" predicate for MPT021; matching is by
#: callee last-name ("send" as a substring covers _send_with_retry,
#: isend etc.)
WIRE_COLLECTIVES = (
    "all_gather",
    "all_to_all_single",
    "all_gather_into_tensor",
    "batch_isend_irecv",
    "quantized_rows_hop1",
    "quantized_rows_hop2",
)
#: dtype names whose cast is an explicit f32 upcast
_F32_DTYPES = ("float32", "float64", "float")
#: shape-only methods that preserve a value's precision and provenance
PASSTHROUGH_METHODS = ("reshape", "copy", "ravel", "flatten", "transpose")

MODES = ("off", "bf16", "int8")

_EF_OFF_RE = re.compile(r"#\s*mpit-analysis:\s*ef-off\[([^\]]*)\]")


@dataclasses.dataclass(frozen=True)
class Site:
    rel: str
    line: int
    col: int
    symbol: str

    def short(self) -> str:
        return f"{self.rel}:{self.line}"


def _site(mod, node) -> Site:
    return Site(
        rel=mod.rel,
        line=getattr(node, "lineno", 0),
        col=getattr(node, "col_offset", 0),
        symbol=astutil.enclosing_symbol(node, mod.parents),
    )


@dataclasses.dataclass
class QuantSite:
    """One call into a quantize kernel, with its error-feedback verdict."""

    site: Site
    func: str
    mode: Optional[str]  # literal-resolved, else None
    paired: bool = False  # residual fold seen (here or in a caller)
    sent: bool = False  # value reaches a send/collective wire hop
    escaped: bool = False  # reconstruction/codes returned to callers
    ef_off: Optional[str] = None  # marker reason, when annotated

    @property
    def ef(self) -> str:
        if self.ef_off is not None:
            return "ef-off"
        if self.paired:
            return "paired"
        if self.sent:
            return "unpaired"
        if self.escaped:
            return "escapes"
        return "local"


@dataclasses.dataclass(frozen=True)
class DequantSite:
    site: Site
    func: str
    declared_mode: Optional[str]  # mode argument, literal-resolved
    codes_mode: Optional[str]  # provenance: the producing quantize's mode
    codes_origin: Optional[Site]
    scale_is_none: bool
    scale_origin: Optional[Site]  # quantize site the scale came from


@dataclasses.dataclass(frozen=True)
class ReduceSite:
    site: Site
    func: str
    operand: str  # "codes[int8]" / "codes[?]" / "qarray[bf16]" / "f32"


@dataclasses.dataclass
class NumericsModel:
    quant_sites: List[QuantSite] = dataclasses.field(default_factory=list)
    dequant_sites: List[DequantSite] = dataclasses.field(
        default_factory=list
    )
    reduce_sites: List[ReduceSite] = dataclasses.field(default_factory=list)
    # tag -> {"name", "inferred": [...], "locked": [...] | None,
    #         "site": Site | None} — the wire-tag precision ledger
    tag_precision: Dict[int, dict] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "quant_sites": [
                {
                    "site": q.site.short(),
                    "symbol": q.site.symbol,
                    "func": q.func,
                    "mode": q.mode or "?",
                    "ef": q.ef,
                    **(
                        {"ef_off_reason": q.ef_off}
                        if q.ef_off is not None
                        else {}
                    ),
                }
                for q in self.quant_sites
            ],
            "dequant_sites": [
                {
                    "site": d.site.short(),
                    "symbol": d.site.symbol,
                    "func": d.func,
                    "declared_mode": d.declared_mode or "?",
                    "codes_mode": d.codes_mode or "?",
                    "scale": "none" if d.scale_is_none else "carried",
                }
                for d in self.dequant_sites
            ],
            "reduce_sites": [
                {
                    "site": r.site.short(),
                    "symbol": r.site.symbol,
                    "func": r.func,
                    "operand": r.operand,
                }
                for r in self.reduce_sites
            ],
            "tags": {
                str(tag): {
                    "name": ent["name"],
                    "inferred": ent["inferred"],
                    "locked": ent["locked"],
                }
                for tag, ent in sorted(self.tag_precision.items())
            },
        }


# ---------------------------------------------------------------------------
# abstract values


@dataclasses.dataclass(frozen=True)
class _Val:
    """One abstract value in the precision lattice. ``origins`` carries
    the quantize-site identities whose codes/QuantArray this value IS
    (or contains); ``deq_of`` the sites whose f32 reconstruction it is —
    the Sub operand that closes the EF recurrence."""

    prec: str = "unknown"  # f32|codes|qarray|pair|scale|container|str|none
    mode: Optional[str] = None
    origins: FrozenSet[int] = frozenset()
    deq_of: FrozenSet[int] = frozenset()


_UNKNOWN = _Val()
_F32 = _Val(prec="f32")


@dataclasses.dataclass(frozen=True)
class _Escape:
    """One value escaping a function via return: tuple index (None for
    the whole value), the quant sites it carries as codes, and the sites
    it reconstructs."""

    index: Optional[int]
    origins: FrozenSet[int]
    deq_of: FrozenSet[int]


class _FnEval:
    """Order-preserving abstract evaluation of one function body (or the
    module toplevel). Claims only what it can trace: unknown swallows
    everything it cannot."""

    def __init__(self, builder, mod, fn_name: str):
        self.b = builder
        self.mod = mod
        self.fn_name = fn_name
        self.env: Dict[str, _Val] = {}
        self.escapes: List[_Escape] = []

    # -- statements ------------------------------------------------------

    def run(self, body) -> None:
        for stmt in body:
            self.stmt(stmt)

    def stmt(self, s) -> None:
        if isinstance(s, ast.Assign):
            val = self.eval(s.value)
            for tgt in s.targets:
                self._bind(tgt, val, s.value)
        elif isinstance(s, ast.AnnAssign) and s.value is not None:
            self._bind(s.target, self.eval(s.value), s.value)
        elif isinstance(s, ast.AugAssign):
            self.eval(s.value)
            if isinstance(s.target, ast.Name):
                self.env[s.target.id] = _UNKNOWN
        elif isinstance(s, ast.Expr):
            self.eval(s.value)
        elif isinstance(s, ast.Return):
            self._escape(s.value)
        elif isinstance(s, (ast.If, ast.While)):
            self.eval(s.test)
            self.run(s.body)
            self.run(s.orelse)
        elif isinstance(s, ast.For):
            self.eval(s.iter)
            if isinstance(s.target, ast.Name):
                self.env[s.target.id] = _UNKNOWN
            self.run(s.body)
            self.run(s.orelse)
        elif isinstance(s, ast.With):
            for item in s.items:
                self.eval(item.context_expr)
            self.run(s.body)
        elif isinstance(s, ast.Try):
            self.run(s.body)
            for h in s.handlers:
                self.run(h.body)
            self.run(s.orelse)
            self.run(s.finalbody)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.b.eval_function(self.mod, s)
        # everything else (imports, class defs, global...) carries no flow

    def _bind(self, tgt, val: _Val, value_node) -> None:
        if isinstance(tgt, ast.Name):
            self.env[tgt.id] = val
            return
        if isinstance(tgt, (ast.Tuple, ast.List)):
            names = [
                e.id if isinstance(e, ast.Name) else None for e in tgt.elts
            ]
            if val.prec == "pair" and len(names) == 2:
                # codes, scale = quantize_*(x, mode)
                if names[0]:
                    self.env[names[0]] = _Val(
                        "codes", val.mode, val.origins
                    )
                if names[1]:
                    self.env[names[1]] = _Val(
                        "scale", val.mode, val.origins
                    )
                return
            if val.prec in ("triple", "requant") and len(names) == 3:
                # codes, scales, sent = quantized_rows_encode(c, mode)
                # codes, scales, r2 = quantized_rows_reduce(...)
                if names[0]:
                    self.env[names[0]] = _Val(
                        "codes", val.mode, val.origins
                    )
                if names[1]:
                    self.env[names[1]] = _Val(
                        "scale", val.mode, val.origins
                    )
                if val.prec == "triple":
                    if names[2]:
                        self.env[names[2]] = _Val(
                            "f32", deq_of=val.origins
                        )
                elif names[2] != "_":
                    # the helper folded the residual itself: keeping
                    # it (in a name or in state) is the EF pairing
                    for sid in val.origins:
                        self.b.mark_paired(sid)
                return
            # a call into a summarized local fn: place escaped values
            summ = self.b.call_escapes(self.mod, value_node)
            if summ is not None:
                for esc in summ:
                    if (
                        esc.index is not None
                        and esc.index < len(names)
                        and names[esc.index]
                    ):
                        self.env[names[esc.index]] = _Val(
                            "container",
                            None,
                            esc.origins,
                            esc.deq_of,
                        )
                for i, n in enumerate(names):
                    if n and n not in self.env:
                        self.env[n] = _UNKNOWN
                # leave names already bound by escapes alone
                for n in names:
                    if n and n not in self.env:
                        self.env[n] = _UNKNOWN
                return
            for n in names:
                if n:
                    self.env[n] = _UNKNOWN
            return
        # attribute/subscript stores: no tracking (self._x = ... is state
        # the schema/threads passes own)

    def _escape(self, value) -> None:
        if value is None:
            return
        if isinstance(value, (ast.Tuple, ast.List)):
            for i, el in enumerate(value.elts):
                v = self.eval(el)
                if v.origins or v.deq_of:
                    self.escapes.append(_Escape(i, v.origins, v.deq_of))
            return
        v = self.eval(value)
        if v.origins or v.deq_of:
            self.escapes.append(_Escape(None, v.origins, v.deq_of))

    # -- expressions -----------------------------------------------------

    def eval(self, node) -> _Val:
        if node is None:
            return _UNKNOWN
        if isinstance(node, ast.Name):
            return self.env.get(node.id, _UNKNOWN)
        if isinstance(node, ast.Constant):
            if node.value is None:
                return _Val(prec="none")
            if isinstance(node.value, str):
                return _Val(prec="str", mode=node.value)
            return _UNKNOWN
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            origins: FrozenSet[int] = frozenset()
            deq: FrozenSet[int] = frozenset()
            for el in node.elts:
                v = self.eval(el)
                origins |= v.origins
                deq |= v.deq_of
            return _Val("container", None, origins, deq)
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, ast.Subscript):
            self.eval(node.slice)
            base = self.eval(node.value)
            # slicing/indexing preserves codes-ness and reconstruction
            if base.prec in ("codes", "qarray", "f32", "container"):
                return base
            return _UNKNOWN
        if isinstance(node, ast.BinOp):
            left, right = self.eval(node.left), self.eval(node.right)
            if isinstance(node.op, ast.Sub):
                # x - dequantize(quantize(x)): the EF fold. Either side
                # being a reconstruction closes the recurrence for the
                # quantize sites it reconstructs.
                for sid in left.deq_of | right.deq_of:
                    self.b.mark_paired(sid)
            if left.prec == "f32" and right.prec == "f32":
                return _F32
            return _UNKNOWN
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand)
            return _F32 if v.prec == "f32" else _UNKNOWN
        if isinstance(node, (ast.BoolOp, ast.Compare)):
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, ast.expr):
                    self.eval(sub)
            return _UNKNOWN
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            a, b = self.eval(node.body), self.eval(node.orelse)
            if a.prec == b.prec == "f32":
                return _F32
            return _UNKNOWN
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for gen in node.generators:
                self.eval(gen.iter)
            v = self.eval(node.elt)
            return _Val("container", None, v.origins, v.deq_of)
        if isinstance(node, ast.DictComp):
            for gen in node.generators:
                self.eval(gen.iter)
            self.eval(node.key)
            v = self.eval(node.value)
            return _Val("container", None, v.origins, v.deq_of)
        if isinstance(node, ast.Attribute):
            self.eval(node.value)
            return _UNKNOWN
        # anything else: evaluate child expressions for their side
        # effects, claim nothing
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, ast.expr):
                self.eval(sub)
        return _UNKNOWN

    def _resolve_mode(self, node) -> Optional[str]:
        v = self.eval(node) if node is not None else _UNKNOWN
        if v.prec == "str" and v.mode in MODES:
            return v.mode
        return None

    def _call(self, call: ast.Call) -> _Val:
        name = astutil.call_last_name(call)
        argvals = [self.eval(a) for a in call.args]
        for kw in call.keywords:
            argvals.append(self.eval(kw.value))

        if name in QUANT_FNS and not self.b.locally_defined(
            self.mod, name
        ):
            mode = self._resolve_mode(astutil.get_arg(call, 1, "mode"))
            sid = self.b.register_quant(self.mod, call, name, mode)
            kind = QUANT_FNS[name]
            return _Val(kind, mode, frozenset((sid,)))

        if name in DEQUANT_FNS and not self.b.locally_defined(
            self.mod, name
        ):
            return self._dequant_call(call, name, argvals)

        if name in REDUCE_FNS:
            operand = argvals[0] if call.args else _UNKNOWN
            if isinstance(call.func, ast.Attribute):
                # a method reduction (codes.sum(0)) reduces its receiver
                recv = self.eval(call.func.value)
                if recv.prec in ("codes", "qarray", "pair", "f32"):
                    operand = recv
            if operand.prec in ("codes", "qarray", "pair"):
                self.b.register_reduce(
                    self.mod, call, name or "?", operand
                )
            # an accumulation is a fresh value: provenance ends here
            return _F32 if operand.prec in ("f32",) else _UNKNOWN

        if name in WIRE_COLLECTIVES:
            for v in argvals:
                for sid in v.origins:
                    self.b.mark_sent(sid)
            # the wire hop moves codes between ranks, it does not change
            # what they are: first-arg passthrough
            return argvals[0] if argvals else _UNKNOWN

        if any(
            (astutil.dotted_name(a) or "").rsplit(".", 1)[-1]
            in WIRE_COLLECTIVES
            for a in call.args
        ):
            # a call handed a wire hop applies it to its other arguments
            # (``self._timed_hop(quantized_rows_hop1, (codes, ...), ...)``)
            for v in argvals:
                for sid in v.origins:
                    self.b.mark_sent(sid)
            return _UNKNOWN

        if name and "send" in name.lower():
            for v in argvals:
                for sid in v.origins:
                    self.b.mark_sent(sid)
            return _UNKNOWN

        if name == "append" and isinstance(call.func, ast.Attribute):
            # parts.append((sid, q)): the container inherits q's
            # provenance, so a later send of `parts` is a send of q
            base = call.func.value
            if isinstance(base, ast.Name):
                have = self.env.get(base.id, _UNKNOWN)
                extra_o = frozenset().union(
                    *[v.origins for v in argvals] or [frozenset()]
                )
                extra_d = frozenset().union(
                    *[v.deq_of for v in argvals] or [frozenset()]
                )
                if extra_o or extra_d:
                    self.env[base.id] = _Val(
                        "container",
                        None,
                        have.origins | extra_o,
                        have.deq_of | extra_d,
                    )
            return _UNKNOWN

        if name in PASSTHROUGH_METHODS and isinstance(
            call.func, ast.Attribute
        ):
            return self.eval(call.func.value)

        if name in ("astype", "to", "float") and isinstance(
            call.func, ast.Attribute
        ):
            base = self.eval(call.func.value)
            dt = astutil.dotted_name(call.args[0]) if call.args else None
            if name == "float" and not call.args:
                dt = "float32"  # t.float() is the f32 cast
            if dt and dt.rsplit(".", 1)[-1] in _F32_DTYPES:
                # an explicit f32 upcast: stop claiming codes-ness (the
                # scale application is the caller's business now)
                return _Val("f32", deq_of=base.deq_of)
            return _UNKNOWN

        # a call into a local function whose returns were summarized:
        # the escaped provenance flows to the caller
        summ = self.b.call_escapes(self.mod, call)
        if summ is not None and name is not None:
            self.b.register_helper_ef_off(self.mod, call, name, summ)
        if summ is not None:
            origins: FrozenSet[int] = frozenset()
            deq: FrozenSet[int] = frozenset()
            for esc in summ:
                origins |= esc.origins
                deq |= esc.deq_of
            if origins or deq:
                return _Val("container", None, origins, deq)
        return _UNKNOWN

    def _dequant_call(self, call, name, argvals) -> _Val:
        mode_pos = DEQUANT_FNS[name]
        codes_v = argvals[0] if call.args else _UNKNOWN
        if mode_pos is None:
            # host face: dequantize(q) — the mode rides in the
            # QuantArray; mismatch is impossible by construction
            declared = codes_v.mode
            scale_is_none = False
            scale_v = codes_v
        else:
            declared = self._resolve_mode(
                astutil.get_arg(call, mode_pos, "mode")
            )
            scale_node = astutil.get_arg(call, 1, "scale")
            scale_is_none = isinstance(
                scale_node, ast.Constant
            ) and scale_node.value is None
            scale_v = self.eval(scale_node) if scale_node else _UNKNOWN
        codes_mode, codes_origin = self.b.origin_of(codes_v.origins)
        _, scale_origin = self.b.origin_of(scale_v.origins)
        self.b.register_dequant(
            self.mod,
            call,
            name,
            declared,
            codes_mode,
            codes_origin,
            scale_is_none,
            scale_origin,
            scale_same=(
                not scale_v.origins or scale_v.origins == codes_v.origins
            ),
        )
        return _Val(prec="f32", deq_of=codes_v.origins)


class _Builder:
    def __init__(self, project):
        self.project = project
        self.model = NumericsModel()
        # (rel, line, col) -> quant site id; ids index self._qsites
        self._qkeys: Dict[tuple, int] = {}
        self._qsites: List[QuantSite] = []
        self._dkeys: set = set()
        self._rkeys: set = set()
        self._local_defs: Dict[str, set] = {}
        self._ef_off: Dict[str, Dict[int, str]] = {}
        # fn name (per module) -> escapes, for the one-level caller pass
        self._summaries: Dict[str, Dict[str, List[_Escape]]] = {}
        self._shadow = False  # pass 2: re-eval callers, no new claims

    # -- module prep -----------------------------------------------------

    def tracked_modules(self) -> list:
        out = []
        for mod in self.project.modules:
            if not any("quant" in ln for ln in mod.source_lines):
                continue  # prefilter: codes only originate from the
                # quant kernels, so a module that never says "quant"
                # cannot contribute (the 5s whole-package pin)
            defs = {
                n.name
                for n in mod.nodes
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            if "quantize" in defs and "dequantize" in defs:
                continue  # the kernel module itself defines the contract
            self._local_defs[mod.rel] = defs
            self._ef_off[mod.rel] = self._markers(mod)
            out.append(mod)
        return out

    @staticmethod
    def _markers(mod) -> Dict[int, str]:
        out = {}
        for i, ln in enumerate(mod.source_lines, start=1):
            m = _EF_OFF_RE.search(ln)
            if m:
                out[i] = m.group(1).strip()
        return out

    def locally_defined(self, mod, name: str) -> bool:
        return name in self._local_defs.get(mod.rel, ())

    # -- site registry (idempotent: pass 2 re-evaluates callers) ---------

    def register_quant(self, mod, call, func, mode) -> int:
        key = (mod.rel, call.lineno, call.col_offset)
        sid = self._qkeys.get(key)
        if sid is None:
            site = _site(mod, call)
            reason = self._ef_off[mod.rel].get(
                call.lineno, self._ef_off[mod.rel].get(call.lineno - 1)
            )
            sid = len(self._qsites)
            self._qkeys[key] = sid
            self._qsites.append(
                QuantSite(site=site, func=func, mode=mode, ef_off=reason)
            )
        return sid

    def register_helper_ef_off(self, mod, call, func, summ) -> None:
        """A call into a same-module helper that returns quantize
        provenance, on a line marked ``ef-off[reason]``: the caller's
        path is declared stateless, so it lists as a site of its own."""
        markers = self._ef_off[mod.rel]
        reason = markers.get(call.lineno, markers.get(call.lineno - 1))
        if reason is None or not any(e.origins or e.deq_of for e in summ):
            return
        key = (mod.rel, call.lineno, call.col_offset)
        if key not in self._qkeys:
            self._qkeys[key] = len(self._qsites)
            self._qsites.append(
                QuantSite(
                    site=_site(mod, call), func=func, mode=None,
                    ef_off=reason,
                )
            )

    def register_dequant(
        self,
        mod,
        call,
        func,
        declared,
        codes_mode,
        codes_origin,
        scale_is_none,
        scale_origin,
        scale_same,
    ) -> None:
        key = (mod.rel, call.lineno, call.col_offset)
        if key in self._dkeys:
            return
        self._dkeys.add(key)
        self.model.dequant_sites.append(
            DequantSite(
                site=_site(mod, call),
                func=func,
                declared_mode=declared,
                codes_mode=codes_mode,
                codes_origin=codes_origin,
                scale_is_none=scale_is_none,
                scale_origin=None if scale_same else scale_origin,
            )
        )

    def register_reduce(self, mod, call, func, operand: _Val) -> None:
        key = (mod.rel, call.lineno, call.col_offset)
        if key in self._rkeys:
            return
        self._rkeys.add(key)
        mode, _ = self.origin_of(operand.origins)
        label = "qarray" if operand.prec == "qarray" else "codes"
        self.model.reduce_sites.append(
            ReduceSite(
                site=_site(mod, call),
                func=func,
                operand=f"{label}[{mode or '?'}]",
            )
        )

    def mark_paired(self, sid: int) -> None:
        self._qsites[sid].paired = True

    def mark_sent(self, sid: int) -> None:
        self._qsites[sid].sent = True

    def origin_of(self, origins: FrozenSet[int]) -> tuple:
        """(mode, site) when provenance is a single quantize site with a
        resolved mode; (None, site-or-None) otherwise — no claim."""
        if len(origins) != 1:
            return None, None
        q = self._qsites[next(iter(origins))]
        return q.mode, q.site

    # -- function evaluation --------------------------------------------

    def eval_function(self, mod, fn) -> None:
        name = getattr(fn, "name", None) or "<module>"
        ev = _FnEval(self, mod, name)
        ev.run(fn.body if hasattr(fn, "body") else fn)
        if not self._shadow and ev.escapes and name != "<module>":
            self._summaries.setdefault(mod.rel, {}).setdefault(
                name, []
            ).extend(ev.escapes)
        # escaped sites: pairing is delegated to callers (pass 2); until
        # a caller pairs them they stay "escapes" — never a claim
        for esc in ev.escapes:
            for sid in esc.origins | esc.deq_of:
                self._qsites[sid].escaped = True

    def call_escapes(self, mod, node) -> Optional[List[_Escape]]:
        if not isinstance(node, ast.Call):
            return None
        name = astutil.call_last_name(node)
        if name is None:
            return None
        return self._summaries.get(mod.rel, {}).get(name)

    # -- drive -----------------------------------------------------------

    def build(self) -> NumericsModel:
        mods = self.tracked_modules()
        fns = []  # (mod, fn-node) in deterministic order
        for mod in mods:
            top = [
                s
                for s in mod.tree.body
                if not isinstance(
                    s, (ast.FunctionDef, ast.AsyncFunctionDef)
                )
            ]
            ev = _FnEval(self, mod, "<module>")
            ev.run(top)
            for s in mod.tree.body:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fns.append((mod, s))
                elif isinstance(s, ast.ClassDef):
                    for m in s.body:
                        if isinstance(
                            m, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            fns.append((mod, m))
        for mod, fn in fns:
            self.eval_function(mod, fn)
        # pass 2: one level of caller context for escaped provenance —
        # re-evaluate only functions that call a summarized name
        self._shadow = True
        for mod, fn in fns:
            names = self._summaries.get(mod.rel)
            if not names:
                continue
            if any(
                isinstance(n, ast.Call)
                and astutil.call_last_name(n) in names
                for n in ast.walk(fn)
            ):
                self.eval_function(mod, fn)
        self.model.quant_sites = list(self._qsites)
        self._tag_precision()
        return self.model

    def _tag_precision(self) -> None:
        """The wire-tag precision ledger: what the schema model infers
        per tag vs the lockfile's ``precision`` column (resolve-or-skip:
        no lock, no column, or no sender site in scan -> no entry)."""
        from mpit_tpu_torch.analysis import lint as lint_mod
        from mpit_tpu_torch.analysis import schema as schema_mod

        if not self.project.modules:
            return
        root = lint_mod.find_repo_root(self.project.modules[0].path)
        lock_path = (
            root / schema_mod.SCHEMA_LOCK_FILENAME
            if root is not None
            else None
        )
        if lock_path is None or not lock_path.exists():
            return
        try:
            locked = json.loads(lock_path.read_text())
        except (OSError, ValueError):
            return
        ltags = locked.get("tags", {})
        if not any("precision" in ent for ent in ltags.values()):
            return  # pre-precision lock: nothing to diff against
        schema = self.project.schema
        doc = schema.to_json()
        for key, ent in sorted(doc["tags"].items(), key=lambda kv: int(kv[0])):
            lt = ltags.get(key)
            if lt is None or "precision" not in lt:
                continue  # a tag the lock doesn't govern (fixtures)
            tag = int(key)
            senders = schema.senders.get(tag)
            site = None
            if senders:
                s0 = senders[0].site
                site = Site(s0.rel, s0.line, s0.col, s0.symbol)
            self.model.tag_precision[tag] = {
                "name": ent["name"] or f"tag {key}",
                "inferred": ent.get("precision", []),
                "locked": lt.get("precision"),
                "site": site,
            }


def build_model(project) -> NumericsModel:
    return _Builder(project).build()
