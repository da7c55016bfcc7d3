"""Trace a GLM link written in torch into a CUDA device functor.

The JAX package's Pallas GLM kernel traces any ``jnp`` link ``link(eta, y)
-> (mu_eff, ll_terms)`` into its body (``mcmc_tpu/ops/fused_logreg.py``
``make_fused_trajectory``). This module is the port's counterpart for its
CUDA kernels: :func:`trace_link` runs the user's torch callable once under
``make_fx`` (``torch.fx.experimental.proxy_tensor``) on f32 example
tensors of one element, ``eta`` of shape ``(1, 1)`` and ``y`` of shape
``(1,)`` (so that a tensor the callable captures broadcasts, and is then
refused by its shape rather than by a failed trace), and turns
the aten graph it records into C++: one statement per node, in a functor
with the built-in links' signature (``csrc/fused_glm_common.cuh``,
``BuiltinLink``)::

    struct TracedLink {
      template <bool WANT_LL>
      static __device__ __forceinline__ float residual(float nu, float eta,
                                                       float y, float* ll);
    };

which returns ``y - mu_eff`` and, with ``WANT_LL``, stores the
log-likelihood term in ``*ll``. :func:`mcmc_tpu_torch.ops._cuda.build_link`
compiles it into the GLM bodies.

What it emits, so that a traced link is held to its plain version (the
same callable run by torch) and not to a built-in's fast-math bits: every
operation rounds as torch's elementwise kernel of that operation does --
``__fadd_rn``, ``__fsub_rn`` and ``__fmul_rn`` keep the compiler from
contracting a product and a sum into one fused multiply-add, and every
quotient is ``div_rn`` (``csrc/fused_glm_common.cuh``), correctly rounded as
``__fdiv_rn`` but without its slow-path call -- and the special functions
are CUDA's accurate ones (``expf``, ``log1pf``, ``expm1f``, ``erff``, ...;
never ``__expf``). Python-float constants are
written exactly, as the hex-float literal of their f32 value, and a 0-d
tensor the callable captures is folded to its value.

The op table (:data:`OPS`): add, sub, rsub, mul, div, neg, reciprocal; pow
with a scalar exponent or base, sqrt, rsqrt, abs; exp, exp2, expm1, log,
log2, log10, log1p, sigmoid, tanh, erf, erfc, lgamma, sin, cos; softplus
with torch's ``beta`` and ``threshold``; clamp, clamp_min, clamp_max,
maximum, minimum; where with gt, ge, lt, le, eq, ne and the logical
not, and, or; full_like, zeros_like, ones_like, scalar constants, and a
copy to f32. Anything else raises ``NotImplementedError`` naming the aten
op: a link must be elementwise in ``(eta, y)`` with scalar constants. That
refuses a reduction, a view or an index, a matrix product, a captured
tensor with elements (a per-datum offset, say) and control flow that
depends on the data -- the Pallas kernel cannot close over an array
either. An output that broadcasts (a term in ``y`` alone, a constant) is
fine.

Nothing here needs a card or a compiler: the tests compile the emitted
functor as host code with ``g++`` (:data:`HOST_SHIM` maps the device
intrinsics to the C library) and hold each op against torch's.
"""

from __future__ import annotations

import hashlib
import math
import struct
import weakref
from typing import NamedTuple

import torch

__all__ = ["TracedLink", "trace_link", "emit_functor", "OPS", "HOST_SHIM",
           "FUNCTOR_NAME"]

FUNCTOR_NAME = "TracedLink"

# example inputs the callable is traced on: a (chains, rows) predictor and
# the rows' responses, as the kernel's plain version hands them over, of one
# element each (module docstring)
_ETA_SHAPE, _Y_SHAPE = (1, 1), (1,)


class TracedLink(NamedTuple):
    """A callable link traced to C++: ``source`` is the functor's
    definition, ``ops`` the aten ops it was traced to, in order,
    ``digest`` a hash of ``source``, and ``sfu`` the special-function
    operations (:data:`SFU_OPS`) of an evaluation: those the residual needs
    (every gradient) and those only the log-likelihood term adds (the last
    gradient)."""
    source: str
    ops: tuple
    digest: str
    sfu: tuple


# the least special-function-unit operations of each op as emitted, for a
# traced link's bound (an accurate expf, logf, expm1f or log1pf, erff or
# tanhf at least one; a quotient's reciprocal one; sigmoid and softplus an
# exponential and a quotient or a logarithm; pow a logarithm and an
# exponential; rsqrt a square root and a quotient)
SFU_OPS = {"aten.exp.default": 1, "aten.exp2.default": 1,
           "aten.expm1.default": 1, "aten.log.default": 1,
           "aten.log2.default": 1, "aten.log10.default": 1,
           "aten.log1p.default": 1, "aten.sigmoid.default": 2,
           "aten.softplus.default": 2, "aten.div.Tensor": 1,
           "aten.div.Scalar": 1, "aten.reciprocal.default": 1,
           "aten.sqrt.default": 1, "aten.rsqrt.default": 2,
           "aten.tanh.default": 1, "aten.erf.default": 1,
           "aten.erfc.default": 1, "aten.lgamma.default": 2,
           "aten.sin.default": 1, "aten.cos.default": 1,
           "aten.pow.Tensor_Scalar": 2, "aten.pow.Scalar": 2,
           "aten.pow.Tensor_Tensor": 2}


def _f32(v) -> float:
    """``v`` rounded to f32, as torch rounds a Python scalar for an f32
    tensor's elementwise op."""
    return struct.unpack("f", struct.pack("f", float(v)))[0]


def _literal(v) -> str:
    """The exact C++ literal of ``v``'s f32 value."""
    if isinstance(v, bool):
        return "1.0f" if v else "0.0f"
    x = _f32(v)
    if math.isnan(x):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(x):
        inf = "__int_as_float(0x7f800000)"
        return inf if x > 0 else f"(-{inf})"
    return f"{x.hex()}f"


def _call(fn):
    return lambda *a: f"{fn}({', '.join(a)})"


def _nan_or(x, expr):
    # torch's clamp, maximum and minimum propagate a NaN operand; fminf
    # and fmaxf would drop it
    return f"(({x}) != ({x}) ? ({x}) : {expr})"


def _pow_scalar(x, e):
    """``x ** e`` for a Python-number exponent, with the exponents torch's
    pow kernel computes without ``pow`` (``aten/src/ATen/native/Pow.cpp``
    and its CUDA kernel: 0.5, 2, 3, -0.5, -1, -2)."""
    e = float(e)
    if e == 1.0:
        return f"({x})"
    if e == 0.0:
        return "1.0f"
    if e == 2.0:
        return f"__fmul_rn({x}, {x})"
    if e == 3.0:
        return f"__fmul_rn(__fmul_rn({x}, {x}), {x})"
    if e == 0.5:
        return f"sqrtf({x})"
    if e == -0.5:
        return f"div_rn(1.0f, sqrtf({x}))"
    if e == -1.0:
        return f"div_rn(1.0f, {x})"
    if e == -2.0:
        return f"div_rn(1.0f, __fmul_rn({x}, {x}))"
    return f"powf({x}, {_literal(e)})"


def _add(a, b, alpha=1):
    if alpha != 1:
        b = f"__fmul_rn({_literal(alpha)}, {b})"
    return f"__fadd_rn({a}, {b})"


def _sub(a, b, alpha=1):
    if alpha != 1:
        b = f"__fmul_rn({_literal(alpha)}, {b})"
    return f"__fsub_rn({a}, {b})"


def _softplus(x, beta=1.0, threshold=20.0):
    bx = x if float(beta) == 1.0 else f"__fmul_rn({x}, {_literal(beta)})"
    sp = f"log1pf(expf({bx}))"
    if float(beta) != 1.0:
        sp = f"div_rn({sp}, {_literal(beta)})"
    return f"(({bx}) > {_literal(threshold)} ? ({x}) : {sp})"


def _clamp(x, lo=None, hi=None):
    out = x
    if lo is not None:
        out = f"fmaxf({out}, {lo})"
    if hi is not None:
        out = f"fminf({out}, {hi})"
    return _nan_or(x, out)


def _where(c, a, b):
    return f"(({c}) ? ({a}) : ({b}))"


def _cmp(op):
    return lambda a, b: f"(({a}) {op} ({b}))"


# aten op (its overload's full name) -> (emitter of its C++ expression from
# the arguments' expressions, result type; None: an identity). Tensor
# arguments arrive as C++ names, Python numbers as exact literals, except
# where emit_functor hands a parameter over as the number it is (an
# exponent, softplus's beta and threshold, alpha).
OPS = {
    "aten.add.Tensor": (_add, "float"),
    "aten.add.Scalar": (_add, "float"),
    "aten.sub.Tensor": (_sub, "float"),
    "aten.sub.Scalar": (_sub, "float"),
    "aten.rsub.Scalar": (lambda a, b, alpha=1: _sub(b, a, alpha), "float"),
    "aten.rsub.Tensor": (lambda a, b, alpha=1: _sub(b, a, alpha), "float"),
    "aten.mul.Tensor": (_call("__fmul_rn"), "float"),
    "aten.mul.Scalar": (_call("__fmul_rn"), "float"),
    "aten.div.Tensor": (_call("div_rn"), "float"),
    "aten.div.Scalar": (_call("div_rn"), "float"),
    "aten.neg.default": (lambda x: f"(-({x}))", "float"),
    "aten.reciprocal.default": (lambda x: f"div_rn(1.0f, {x})", "float"),
    "aten.pow.Tensor_Scalar": (None, "float"),   # by its exponent, below
    "aten.pow.Scalar": (_call("powf"), "float"),
    "aten.pow.Tensor_Tensor": (_call("powf"), "float"),
    "aten.sqrt.default": (_call("sqrtf"), "float"),
    "aten.rsqrt.default": (lambda x: f"div_rn(1.0f, sqrtf({x}))",
                           "float"),
    "aten.abs.default": (_call("fabsf"), "float"),
    "aten.exp.default": (_call("expf"), "float"),
    "aten.exp2.default": (_call("exp2f"), "float"),
    "aten.expm1.default": (_call("expm1f"), "float"),
    "aten.log.default": (_call("logf"), "float"),
    "aten.log2.default": (_call("log2f"), "float"),
    "aten.log10.default": (_call("log10f"), "float"),
    "aten.log1p.default": (_call("log1pf"), "float"),
    "aten.sigmoid.default": (
        lambda x: f"div_rn(1.0f, __fadd_rn(1.0f, expf(-({x}))))",
        "float"),
    "aten.tanh.default": (_call("tanhf"), "float"),
    "aten.erf.default": (_call("erff"), "float"),
    "aten.erfc.default": (_call("erfcf"), "float"),
    "aten.lgamma.default": (_call("lgammaf"), "float"),
    "aten.sin.default": (_call("sinf"), "float"),
    "aten.cos.default": (_call("cosf"), "float"),
    "aten.softplus.default": (_softplus, "float"),
    "aten.clamp.default": (_clamp, "float"),
    "aten.clamp.Tensor": (_clamp, "float"),
    "aten.clamp_min.default": (lambda x, lo: _clamp(x, lo=lo), "float"),
    "aten.clamp_max.default": (lambda x, hi: _clamp(x, hi=hi), "float"),
    "aten.maximum.default": (
        lambda a, b: _nan_or(b, _nan_or(a, f"fmaxf({a}, {b})")), "float"),
    "aten.minimum.default": (
        lambda a, b: _nan_or(b, _nan_or(a, f"fminf({a}, {b})")), "float"),
    "aten.where.self": (_where, "float"),
    "aten.logical_not.default": (lambda x: f"(!({x}))", "bool"),
    "aten.logical_and.default": (lambda a, b: f"(({a}) && ({b}))", "bool"),
    "aten.logical_or.default": (lambda a, b: f"(({a}) || ({b}))", "bool"),
    # ~, & and | of the comparisons' bool tensors (any other dtype is
    # refused by its result's type)
    "aten.bitwise_not.default": (lambda x: f"(!({x}))", "bool"),
    "aten.bitwise_and.Tensor": (lambda a, b: f"(({a}) && ({b}))", "bool"),
    "aten.bitwise_or.Tensor": (lambda a, b: f"(({a}) || ({b}))", "bool"),
    "aten.full_like.default": (lambda _x, v: v, "float"),
    "aten.zeros_like.default": (lambda _x: "0.0f", "float"),
    "aten.ones_like.default": (lambda _x: "1.0f", "float"),
    "aten.scalar_tensor.default": (lambda v: v, "float"),
    "aten.lift_fresh_copy.default": (lambda x: x, None),
    "aten.clone.default": (lambda x: x, None),
    "aten.alias.default": (lambda x: x, None),
    "aten.detach.default": (lambda x: x, None),
    "aten._to_copy.default": (lambda x: f"(float)({x})", "float"),
}
for _name, _op in (("gt", ">"), ("ge", ">="), ("lt", "<"), ("le", "<="),
                   ("eq", "=="), ("ne", "!=")):
    OPS[f"aten.{_name}.Scalar"] = (_cmp(_op), "bool")
    OPS[f"aten.{_name}.Tensor"] = (_cmp(_op), "bool")

# keyword arguments that carry no arithmetic (an f32 result's type, layout,
# device, memory format); any other keyword is the op's own parameter
_INERT_KWARGS = {"dtype", "layout", "device", "pin_memory", "memory_format",
                 "non_blocking"}
# ops whose arguments after the first are Python numbers that shape the
# arithmetic (an exponent, softplus's beta and threshold)
_SCALAR_PARAMS = {"aten.pow.Tensor_Scalar", "aten.softplus.default"}

_REFUSAL = ("a link must be elementwise in (eta, y) with scalar constants: "
            "no reduction, view, index, matrix product, captured tensor "
            "with elements or data-dependent control flow")


def _refuse(what):
    raise NotImplementedError(
        f"the fused GLM kernel cannot trace {what}: {_REFUSAL} (the op "
        "table is mcmc_tpu_torch.ops.link_codegen.OPS); run it on CPU "
        "tensors")


def _trace(fn):
    from torch.fx.experimental.proxy_tensor import make_fx

    eta = torch.full(_ETA_SHAPE, 0.5)
    y = torch.full(_Y_SHAPE, 1.0)
    try:
        return make_fx(fn)(eta, y)
    except NotImplementedError:
        raise
    except Exception as e:   # noqa: BLE001 -- re-raised with its op named
        msg = str(e)
        if "_local_scalar_dense" in msg or "data-dependent" in msg:
            _refuse("aten._local_scalar_dense (a value read back from a "
                    "traced tensor: data-dependent control flow or "
                    "float()/item())")
        raise NotImplementedError(
            f"the fused GLM kernel could not trace the link ({type(e).__name__}"
            f": {msg.splitlines()[0] if msg else ''}); {_REFUSAL}") from e


def _dtype(node):
    val = node.meta.get("val")
    return getattr(val, "dtype", None)


def emit_functor(gm) -> TracedLink:
    """The functor's C++ for a graph traced by ``make_fx`` from ``link(eta,
    y) -> (mu_eff, ll_terms)``."""
    exprs = {}     # node -> the C++ name or literal of its value
    lines, ops = [], []
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(placeholders) != 2:
        _refuse(f"a callable of {len(placeholders)} arguments (it takes "
                "eta and y)")
    exprs[placeholders[0]], exprs[placeholders[1]] = "eta", "y"

    def arg(a):
        if isinstance(a, torch.fx.Node):
            return exprs[a]
        if isinstance(a, (bool, int, float)):
            return _literal(a)
        if a is None:
            return None
        _refuse(f"an argument {a!r}")

    outputs = None
    for i, node in enumerate(gm.graph.nodes):
        if node.op == "placeholder":
            continue
        if node.op == "get_attr":
            const = getattr(gm, node.target)
            if not torch.is_tensor(const) or const.numel() != 1 \
                    or const.ndim != 0:
                shape = tuple(const.shape) if torch.is_tensor(const) else ()
                _refuse(f"a captured tensor of shape {shape} "
                        f"({node.target})")
            exprs[node] = _literal(const.item())
            continue
        if node.op == "output":
            outputs = node.args[0]
            continue
        if node.op != "call_function":
            _refuse(f"a {node.op} node ({node.target})")
        op = str(node.target)
        if op not in OPS:
            _refuse(op)
        emit, kind = OPS[op]
        dt = _dtype(node)
        # (an identity passes its argument on: a 0-d integer constant is
        # folded, and what uses it is checked)
        if kind is not None and dt not in (None, torch.float32, torch.bool):
            _refuse(f"{op} with a {dt} result (the kernel computes the "
                    "link in float32)")
        if op == "aten._to_copy.default" and \
                node.kwargs.get("dtype", torch.float32) != torch.float32:
            _refuse(f"{op} to {node.kwargs['dtype']}")
        raw = list(node.args)
        kw = {k: v for k, v in node.kwargs.items() if k not in _INERT_KWARGS}
        if any(isinstance(v, torch.fx.Node) for v in
               (raw[1:] if op in _SCALAR_PARAMS else []) + [kw.get("alpha")]):
            _refuse(f"{op} with a traced parameter")
        if op == "aten.pow.Tensor_Scalar":
            expr = _pow_scalar(arg(raw[0]), raw[1])
        elif op == "aten.softplus.default":
            expr = _softplus(arg(raw[0]), *raw[1:],
                             **{k: kw[k] for k in ("beta", "threshold")
                                if k in kw})
        elif "alpha" in kw:
            expr = emit(*[arg(a) for a in raw], alpha=kw.pop("alpha"))
        elif op in ("aten.clamp.default", "aten.clamp.Tensor"):
            lo = raw[1] if len(raw) > 1 else kw.get("min")
            hi = raw[2] if len(raw) > 2 else kw.get("max")
            expr = _clamp(arg(raw[0]), arg(lo), arg(hi))
        else:
            if kw:
                _refuse(f"{op} with keyword arguments {sorted(kw)}")
            try:
                expr = emit(*[arg(a) for a in raw])
            except TypeError:
                _refuse(f"{op} with arguments {node.args}")
        ops.append(op)
        if kind is None:      # an identity: the value of its argument
            exprs[node] = expr
            continue
        var = f"v{i}"
        ctype = "bool" if kind == "bool" or dt == torch.bool else "float"
        lines.append(f"    const {ctype} {var} = {expr};  // {op}")
        exprs[node] = var

    if not isinstance(outputs, (tuple, list)) or len(outputs) != 2:
        _refuse("a callable that does not return (mu_eff, ll_terms)")

    def out(a):
        if isinstance(a, torch.fx.Node):
            return f"(float)({exprs[a]})"
        if isinstance(a, (bool, int, float)):
            return _literal(a)
        _refuse(f"an output {a!r}")

    mu, ll = out(outputs[0]), out(outputs[1])

    def ancestors(a):
        seen, todo = set(), [a] if isinstance(a, torch.fx.Node) else []
        while todo:
            n = todo.pop()
            if n not in seen:
                seen.add(n)
                todo.extend(n.all_input_nodes)
        return seen

    def sfu(nodes):
        return sum(SFU_OPS.get(str(n.target), 0) for n in nodes
                   if n.op == "call_function")

    for_mu = ancestors(outputs[0])
    sfu_counts = (sfu(for_mu), sfu(ancestors(outputs[1]) - for_mu))
    body = "\n".join(lines)
    src = (
        f"// a link traced from torch: {len(ops)} aten ops\n"
        f"struct {FUNCTOR_NAME} {{\n"
        "  template <bool WANT_LL>\n"
        "  static __device__ __forceinline__ float residual(float nu, "
        "float eta,\n"
        "                                                   float y, "
        "float* ll) {\n"
        "    (void)nu;\n"
        f"{body}\n"
        f"    if (WANT_LL) *ll = {ll};\n"
        f"    return __fsub_rn(y, {mu});\n"
        "  }\n"
        "};\n")
    return TracedLink(src, tuple(ops),
                      hashlib.sha256(src.encode()).hexdigest()[:16],
                      sfu_counts)


_cache = weakref.WeakKeyDictionary()


def trace_link(fn) -> TracedLink:
    """Trace the callable link ``fn(eta, y) -> (mu_eff, ll_terms)`` to a
    functor (module docstring). Raises ``NotImplementedError`` naming the
    first aten op outside the table. A callable is traced once (cached by
    the object while it lives); two callables with the same ops give the
    same source, and so share one built library."""
    try:
        hit = _cache.get(fn)
    except TypeError:      # not weakly referenceable: trace every time
        hit = None
    if hit is not None:
        return hit
    gm = _trace(fn)
    traced = emit_functor(gm)
    try:
        _cache[fn] = traced
    except TypeError:
        pass
    return traced


# The device intrinsics the functor uses, as host C++ (for compiling a
# traced functor with a host compiler; the math library names are the C
# library's own, and div_rn, the kernels' correctly rounded quotient, is
# the host's a / b).
HOST_SHIM = """#include <math.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
static inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
}
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float div_rn(float a, float b) { return a / b; }
"""
