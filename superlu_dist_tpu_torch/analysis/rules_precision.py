"""Precision-flow rules — SLU115, SLU116 (source half) and SLU118.

GESP's correctness story (static pivoting + iterative refinement) rests
on arithmetic precision being exactly what the escalation ladder
believes it is: every Schur GEMM can run at bf16 / default (TF32 on the
card) / highest, and acceptance gates compare against float literals
that silently encode a dtype.  These rules audit DTYPE FLOW — the hazard
class the recursive blocked TRSM/TRMM literature calls out, where
accumulation precision (not layout) decides portability
(arXiv:2504.13821).

SLU115 — implicit downcast.  A narrowing ``.to(torch.float32 /
float16 / bfloat16)``, ``.float()``, ``.half()``, ``.bfloat16()`` or
``.astype`` on a value-carrying tensor in ``numeric/`` / ``solve/`` /
``refine/`` silently discards mantissa bits the BERR gate will charge to
"the matrix" three rungs later.  16-bit targets always flag; 32-bit
targets only on a value KNOWN to be f64 (the dataflow width lattice).
The sanctioned tier boundary is ``ops/dense.gemm`` (path-exempt: ops/ is
outside the rule's scope); everything else is flagged, with the witness
chain from the cast site to the consuming GEMM/TRSM when the cast value
demonstrably feeds one.

SLU116 — accumulation dtype, source half.  A ``torch.matmul`` / ``mm``
/ ``bmm`` / ``einsum`` / ``tensordot`` (or the same tensor method, or an
``@`` on a device value) in ``numeric/`` / ``solve/`` bypasses
``ops/dense.gemm``'s ladder: torch has no ``preferred_element_type``, so
what pins such a product's tier is the global TF32 / reduced-precision
flag of the moment, not the tier the ladder promised.

SLU118 — tolerance hygiene (lexical).  Float comparison literals in the
tolerance band (1e-18, 1e-5] — ``berr < 1e-6`` style, and ``rtol=`` /
``atol=`` kwargs — encode a dtype assumption no reader can audit.

The program halves of SLU115 / SLU116 run over RECORDED PROGRAMS
(``analysis/program.py``, under ``SLU_TPU_VERIFY_DTYPES=1``): a
non-scalar ``_to_copy`` / ``copy_`` to a narrower float dtype is
sanctioned only when it feeds, through shape-only ops (and widening
copies: the bf16 tier's rounded-float32 route), matmul-family ops
producing at least float32 — ``ops/dense._bf16_gemm``'s shape; a
matmul-family op must produce at least its widest float operand's width,
and at least float32 on 16-bit operands.

Port of the JAX package's ``analysis/rules_precision.py``.  Not ported:
SLU117 (df64 error-free-transform purity — the port runs df64 as
float64 and has no pair components).
"""

from __future__ import annotations

import ast

from superlu_dist_tpu_torch.analysis.core import Rule, _norm_parts, dotted_name
from superlu_dist_tpu_torch.analysis.dataflow import (TAINT_DEVICE, FnFlow,
                                                      TORCH_CAST_METHODS,
                                                      float_width_node,
                                                      taint_width,
                                                      to_dtype_arg)

RULE_IMPLICIT_DOWNCAST = "SLU115"
RULE_ACCUM_DTYPE = "SLU116"
RULE_TOL_LITERAL = "SLU118"

#: calls that consume a narrowed value into GEMM-bound linear algebra —
#: the witness targets of SLU115's cast→consumer chain
_PREC_CONSUMERS = frozenset({
    "matmul", "mm", "bmm", "einsum", "tensordot", "dot",
    "solve_triangular", "gemm", "trsm"})

#: private taint kind threading a cast site key through the dataflow
#: (never leaves _NarrowFlow: summarize() runs plain FnFlow)
_TK_NARROW = "_narrow115"


# --------------------------------------------------------------------------
# SLU115 — implicit downcast
# --------------------------------------------------------------------------

def _narrow_target(node: ast.Call):
    """(spelling, width) when `node` converts to a lexically known float
    width: ``.astype(D)`` / ``.to(D)`` / ``.float()`` / ``.half()`` /
    ``.bfloat16()`` / ``.double()``; None otherwise."""
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr in ("astype", "to") and (node.args or node.keywords):
        dt = to_dtype_arg(node)
        w = float_width_node(dt) if dt is not None else None
        return (f".{fn.attr}", w) if w is not None else None
    if fn.attr in TORCH_CAST_METHODS and not node.args \
            and not node.keywords:
        return (f".{fn.attr}()", TORCH_CAST_METHODS[fn.attr])
    return None


class _NarrowFlow(FnFlow):
    """FnFlow that records narrowing conversion sites and the first
    GEMM/TRSM-ish consumer each narrowed value reaches."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # (line, col) -> {node, what, w_from, w_to, consumer}
        self.casts: dict = {}

    def _call_taint_base(self, node: ast.Call) -> dict:
        t = super()._call_taint_base(node)
        hit = _narrow_target(node)
        if hit is not None:
            what, w_to = hit
            w_from = taint_width(self.taint(node.func.value))
            # 16-bit targets are always a downcast of a compute dtype;
            # 32-bit targets only flag on a KNOWN f64 source
            # (false-negative-leaning: plain-f32 code stays quiet)
            if w_to == 16 or (w_from is not None and w_to < w_from):
                key = (node.lineno, node.col_offset)
                self.casts.setdefault(
                    key, {"node": node, "what": what, "w_from": w_from,
                          "w_to": w_to, "consumer": None})
                t = dict(t)
                t[_TK_NARROW] = key
        return t

    def visit_stmt(self, st) -> None:
        for node in ast.walk(st):
            if not isinstance(node, ast.Call):
                continue
            tail = dotted_name(node.func).rsplit(".", 1)[-1]
            if tail not in _PREC_CONSUMERS:
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                key = self.taint(arg).get(_TK_NARROW)
                info = self.casts.get(key) if key is not None else None
                if info is not None and info["consumer"] is None:
                    info["consumer"] = (tail, node.lineno)


class ImplicitDowncastRule(Rule):
    rule_id = RULE_IMPLICIT_DOWNCAST
    title = "implicit-float-downcast"
    hint = ("route reduced-precision arithmetic through the sanctioned "
            "tier boundary (ops/dense.gemm pins the tier per ladder "
            "rung); a bare narrowing conversion silently discards "
            "mantissa bits the BERR gate charges to the matrix")
    package_dirs = ("numeric", "solve", "refine")

    def check(self, tree, source, path, project=None):
        if project is None:
            return []
        out = []
        for qname, fi in project.functions.items():
            if fi.path != path:
                continue
            flow = _NarrowFlow.for_function(project, fi)
            flow.run()
            for key in sorted(flow.casts):
                info = flow.casts[key]
                w_from = info["w_from"]
                src = f"f{w_from}" if w_from else "a compute-width value"
                msg = (f"implicit downcast: `{info['what']}` narrows {src} "
                       f"to f{info['w_to']} on a value-carrying tensor")
                if info["consumer"] is not None:
                    tail, line = info["consumer"]
                    msg += (f" — witness chain: cast at line "
                            f"{info['node'].lineno} -> consumed by "
                            f"`{tail}` at line {line}")
                out.append(self.finding(path, info["node"], msg))
        return out


# --------------------------------------------------------------------------
# SLU116 — accumulation dtype (source half)
# --------------------------------------------------------------------------

_ACCUM_CALLS = frozenset({"matmul", "mm", "bmm", "einsum", "tensordot",
                          "addmm", "baddbmm", "addbmm"})
_ACCUM_METHODS = frozenset({"matmul", "mm", "bmm", "addmm", "baddbmm"})


class _MatMulFlow(FnFlow):
    """FnFlow recording ``@`` products with an operand on the card."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.hits: dict = {}     # (line, col) -> node

    def visit_stmt(self, st) -> None:
        for node in ast.walk(st):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.MatMult) \
                    and any(TAINT_DEVICE in self.taint(side)
                            for side in (node.left, node.right)):
                self.hits.setdefault((node.lineno, node.col_offset), node)


class AccumulationDtypeRule(Rule):
    rule_id = RULE_ACCUM_DTYPE
    title = "unpinned-accumulation-dtype"
    hint = ("route the product through ops/dense.gemm(a, b, prec), which "
            "pins the ladder tier (bf16 products accumulate in float32, "
            "TF32 only on the \"default\" tier) — a bare torch matmul "
            "runs at whatever the global TF32 / reduced-precision flags "
            "say at that moment")
    package_dirs = ("numeric", "solve")

    def check(self, tree, source, path, project=None):
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            tail = name.rsplit(".", 1)[-1]
            if name.split(".", 1)[0] == "torch" and tail in _ACCUM_CALLS:
                what = f"`{name}`"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _ACCUM_METHODS \
                    and name.split(".", 1)[0] not in ("np", "numpy",
                                                      "torch"):
                what = f"`.{node.func.attr}()`"
            else:
                continue
            out.append(self.finding(
                path, node,
                f"{what} outside ops/dense.gemm — the product's tier is "
                "whatever the backend flags say, not what the ladder "
                "promised"))
        if project is not None:
            for qname, fi in project.functions.items():
                if fi.path != path:
                    continue
                flow = _MatMulFlow.for_function(project, fi)
                flow.run()
                for key in sorted(flow.hits):
                    out.append(self.finding(
                        path, flow.hits[key],
                        "`@` on a device value outside ops/dense.gemm — "
                        "the product's tier is whatever the backend flags "
                        "say, not what the ladder promised"))
        return out


# --------------------------------------------------------------------------
# SLU118 — tolerance hygiene
# --------------------------------------------------------------------------

# the tolerance band: narrower than any perf ratio (0.05, 1e-3), wider
# than underflow guards (1e-300).  Named so the rule never flags itself.
_TOL_BAND_LO = 1e-18
_TOL_BAND_HI = 1e-5

_RELATIONAL = (ast.Lt, ast.LtE, ast.Gt, ast.GtE)


def _float_lit(node):
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    if isinstance(node, ast.Constant) and isinstance(node.value, float):
        return node.value
    return None


def _in_band(v) -> bool:
    return _TOL_BAND_LO < abs(v) <= _TOL_BAND_HI


class ToleranceLiteralRule(Rule):
    rule_id = RULE_TOL_LITERAL
    title = "ad-hoc-tolerance-literal"
    hint = ("derive the threshold from utils/tols.py (eps(dtype)*factor "
            "with provenance): tols.tol(dtype, 2**k, why=...) / "
            "tols.berr_target(dtype) / the named gate tolerances — a "
            "bare 1e-N encodes a dtype assumption no reader can audit")
    package_dirs = None

    def applies(self, path: str) -> bool:
        # demo drivers mirror the reference's printed residual checks
        return "examples" not in _norm_parts(path)

    def check(self, tree, source, path, project=None):
        out = []
        seen: set = set()

        def flag(lit_node, v, where):
            key = (lit_node.lineno, lit_node.col_offset)
            if key in seen:
                return
            seen.add(key)
            out.append(self.finding(
                path, lit_node,
                f"float tolerance literal {v!r} in {where} — thresholds "
                "in the band (1e-18, 1e-5] must come from the central "
                "dtype-aware model"))

        for node in ast.walk(tree):
            if isinstance(node, ast.Compare) and any(
                    isinstance(op, _RELATIONAL) for op in node.ops):
                for sub in ast.walk(node):
                    v = _float_lit(sub)
                    if v is not None and _in_band(v):
                        flag(sub, v, "a comparison")
                        if isinstance(sub, ast.UnaryOp):
                            # the walk will visit the inner Constant
                            # too — one literal, one finding
                            seen.add((sub.operand.lineno,
                                      sub.operand.col_offset))
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg not in ("rtol", "atol"):
                        continue
                    v = _float_lit(kw.value)
                    if v is not None and _in_band(v):
                        flag(kw.value, v, f"an {kw.arg}= keyword")
        return out


# --------------------------------------------------------------------------
# the program halves (SLU115 / SLU116 over recorded programs)
# --------------------------------------------------------------------------

#: ops that only re-shape, re-stride or copy a value: a narrowed value may
#: pass through them on its way to the GEMM that consumes it
_SHAPE_ONLY_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "transpose", "t", "permute",
    "expand", "slice", "select", "unsqueeze", "squeeze", "alias",
    "detach", "clone", "contiguous", "as_strided", "_reshape_alias",
    "unflatten", "flatten", "split", "chunk", "cat", "constant_pad_nd",
    "narrow", "lift_fresh"})

#: the matmul family: their accumulator is what SLU116 pins
MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm",
                        "matmul", "linear", "_scaled_mm"})

_NARROWING_OPS = frozenset({"_to_copy", "copy_", "copy"})


def _width(t):
    from superlu_dist_tpu_torch.analysis.program import dtype_width
    return dtype_width(t.dtype)


def _narrowing(op):
    """(source, narrowed output) of a narrowing convert, or None."""
    if op.name not in _NARROWING_OPS or not op.inputs:
        return None
    if op.name == "_to_copy":
        src, dst = op.inputs[0], op.outputs[0] if op.outputs else None
    elif len(op.inputs) >= 2:           # copy_(self, src): self is written
        src, dst = op.inputs[1], op.inputs[0]
    else:
        return None
    if dst is None:
        return None
    w_in, w_out = _width(src), _width(dst)
    if w_in is None or w_out is None or w_out >= w_in:
        return None
    if not src.shape:
        return None                     # scalars carry no values
    return src, dst


def _sanctioned_narrow(ops, start, dst) -> bool:
    """True when every later consumer of the narrowed storage — through
    shape-only ops and widening copies — is a matmul-family op producing
    at least float32 (no consumer: the value escapes; passes)."""
    narrowed = {dst.storage}
    for op in ops[start + 1:]:
        hit = [t for i, t in enumerate(op.inputs) if t.storage in narrowed
               and i not in op.writes]
        if not hit:
            continue
        if op.name in MATMUL_OPS:
            w = _width(op.outputs[0]) if op.outputs else None
            if w is None or w < 32:
                return False
            continue
        widening = op.name == "_to_copy" and op.outputs and all(
            (_width(op.outputs[0]) or 0) >= (_width(t) or 0) for t in hit)
        if op.name in _SHAPE_ONLY_OPS or widening:
            narrowed.update(t.storage for t in op.outputs)
            continue
        return False
    return True


def audit_narrowing(spec):
    """SLU115 over a recorded program: narrowing converts on non-scalar
    values outside the sanctioned GEMM-input pattern.  Returns
    ``(findings, {n_converts, n_narrowing})``."""
    from superlu_dist_tpu_torch.analysis.rules_program import program_finding
    findings = []
    n_converts = n_narrow = 0
    for k, op in enumerate(spec.ops):
        if op.name in _NARROWING_OPS:
            n_converts += 1
        pair = _narrowing(op)
        if pair is None:
            continue
        n_narrow += 1
        src, dst = pair
        if _sanctioned_narrow(spec.ops, k, dst):
            continue
        findings.append(program_finding(
            RULE_IMPLICIT_DOWNCAST, spec,
            f"narrowing `{op.op}` f{_width(src)}->f{_width(dst)} on "
            f"{src.short()} whose consumers are not matmuls accumulating "
            "at float32 or wider — the program silently discards "
            "mantissa bits the ladder never sanctioned",
            "narrow only as GEMM INPUT with the product at float32 or "
            "wider (ops/dense._bf16_gemm's shape), or keep the value at "
            "its compute width"))
    return findings, {"n_converts": n_converts, "n_narrowing": n_narrow}


def audit_accumulation(spec):
    """SLU116 over a recorded program: every matmul-family op must
    produce a float width at least its widest float operand's, and at
    least 32 when any operand is narrower than 32 bits.  Returns
    ``(findings, {n_matmuls})``."""
    from superlu_dist_tpu_torch.analysis.rules_program import program_finding
    findings = []
    n = 0
    for op in spec.ops:
        if op.name not in MATMUL_OPS or not op.outputs:
            continue
        n += 1
        ws = [w for w in (_width(t) for t in op.inputs) if w is not None]
        if not ws:
            continue
        need = max(ws)
        if min(ws) < 32:
            need = max(need, 32)
        w_out = _width(op.outputs[0])
        if w_out is not None and w_out < need:
            findings.append(program_finding(
                RULE_ACCUM_DTYPE, spec,
                f"`{op.op}` produces f{w_out} from operand widths "
                f"{sorted(set(ws))} — required f{need} or wider: the "
                "bf16-GEMM-without-float32-accumulation bug, caught "
                "before the program runs instead of by a BERR gate",
                "route the product through ops/dense.gemm (the bf16 tier "
                "multiplies with out_dtype=torch.float32)"))
    return findings, {"n_matmuls": n}
