"""Band expressions: parsing of `rgb_products` entries, and their
evaluation over numpy values or torch tensors.

Counterpart of `gsky_tpu/ops/expr.py`: the same tokenizer, grammar and
`parse_band_expressions` contract, so a request's variable list and
output names match the reference, and the same evaluator (`_emit`).
The drill's merge runs it over per-date float64 scalars (``xp=np``);
the modular GetMap path over float32 tensors on the pipeline's device
(``xp=torch``, `CompiledExpr.eval_masked`).

Over torch, each xp has its own function table (the reference binds
its table to jnp whatever xp is).  Float32 stays float32 as JAX's weak
types keep it: Python constants combine with tensors in the tensor's
dtype, `where` of two constants is float32, and constant-only calls
round through float32.  Two PyTorch habits would change bits and are
avoided: a division by or of a Python scalar divides by a 0-d tensor
(PyTorch on CUDA multiplies by the scalar's reciprocal instead), and
``log10`` is ``log(x) / log(10)`` as `jnp.log10` lowers.  ``%`` is
`torch.fmod` (truncated, sign of the dividend).  ``**`` takes both
operands as tensors, as ``pow`` does: PyTorch would compute ``x ** 2.0``
as ``x * x`` and ``x ** 0.5`` as ``sqrt(x)``, where a tensor exponent
takes the general power, so an expression evaluates alike whether its
literals arrive as Python floats (the interpreter) or as tensors (the
fused epilogue).

Structural fingerprints (`fingerprint`) are the fused band-algebra
path's key: variables become slot indices in first-use order and
numeric literals const indices in occurrence order, so expressions that
differ only in names or literal values share one key.
`eval_fingerprint` evaluates a key through the same `_emit` as the
interpreter (`ops.paged.expr_epilogue` feeds it the scored mosaic's
planes and the literals as tensors).
"""

from __future__ import annotations

import hashlib
import math
import os
import re
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


def expr_fuse_enabled() -> bool:
    """GSKY_EXPR_FUSE gates the fused band-algebra path (default on):
    ``0`` sends expression layers through the per-band mosaic and
    `evaluate_expressions` instead."""
    return os.environ.get("GSKY_EXPR_FUSE", "1").lower() not in (
        "0", "false", "off", "no")

_TOKEN_RE = re.compile(r"""
    (?P<num>\d+\.\d*(?:[eE][-+]?\d+)?|\.\d+(?:[eE][-+]?\d+)?|\d+(?:[eE][-+]?\d+)?)
  | (?P<name>\[[^\]]+\]|[A-Za-z_][A-Za-z0-9_:.#]*)
  | (?P<op>\*\*|==|!=|<=|>=|&&|\|\||[-+*/%()<>!?:,])
  | (?P<ws>\s+)
""", re.X)

# the functions the grammar recognises (calls parse as ("call", ...))
_FUNCS = {
    "abs": np.abs, "sqrt": np.sqrt, "log": np.log, "log10": np.log10,
    "exp": np.exp, "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "floor": np.floor, "ceil": np.ceil,
    "min": np.minimum, "max": np.maximum, "pow": np.power,
}


def tokenize(src: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise ValueError(f"bad token at {src[pos:pos+10]!r} in {src!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


# AST nodes: ("num", v) ("var", name) ("un", op, a) ("bin", op, a, b)
# ("tern", c, a, b) ("call", fname, [args])

class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def take(self, val=None):
        k, v = self.toks[self.i]
        if val is not None and v != val:
            raise ValueError(f"expected {val!r}, got {v!r}")
        self.i += 1
        return k, v

    def parse(self):
        node = self.ternary()
        if self.peek()[0] != "eof":
            raise ValueError(f"trailing tokens at {self.peek()[1]!r}")
        return node

    def ternary(self):
        cond = self.or_()
        if self.peek()[1] == "?":
            self.take("?")
            a = self.ternary()
            self.take(":")
            b = self.ternary()
            return ("tern", cond, a, b)
        return cond

    def _left(self, ops, sub):
        node = sub()
        while self.peek()[1] in ops:
            op = self.take()[1]
            node = ("bin", op, node, sub())
        return node

    def or_(self):
        return self._left(("||",), self.and_)

    def and_(self):
        return self._left(("&&",), self.cmp)

    def cmp(self):
        return self._left(("==", "!=", "<", "<=", ">", ">="), self.add)

    def add(self):
        return self._left(("+", "-"), self.mul)

    def mul(self):
        return self._left(("*", "/", "%"), self.unary)

    def unary(self):
        if self.peek()[1] in ("-", "!"):
            op = self.take()[1]
            return ("un", op, self.unary())
        return self.power()

    def power(self):
        node = self.atom()
        if self.peek()[1] == "**":
            self.take()
            return ("bin", "**", node, self.unary())  # right assoc
        return node

    def atom(self):
        k, v = self.peek()
        if v == "(":
            self.take("(")
            node = self.ternary()
            self.take(")")
            return node
        if k == "num":
            self.take()
            return ("num", float(v))
        if k == "name":
            self.take()
            name = v[1:-1] if v.startswith("[") else v
            if self.peek()[1] == "(" and name in _FUNCS:
                self.take("(")
                args = [self.ternary()]
                while self.peek()[1] == ",":
                    self.take(",")
                    args.append(self.ternary())
                self.take(")")
                return ("call", name, args)
            return ("var", name)
        raise ValueError(f"unexpected token {v!r}")


def _collect_vars(node, acc):
    tag = node[0]
    if tag == "var":
        acc.append(node[1])
    elif tag == "un":
        _collect_vars(node[2], acc)
    elif tag == "bin":
        _collect_vars(node[2], acc)
        _collect_vars(node[3], acc)
    elif tag == "tern":
        for n in node[1:]:
            _collect_vars(n, acc)
    elif tag == "call":
        for n in node[2]:
            _collect_vars(n, acc)


def _as_tensor(x, like):
    """A Python scalar as a 0-d float32 tensor on ``like``'s device."""
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _tensor_args(args):
    """Scalars among ``args`` as 0-d float32 tensors beside the first
    tensor; None when no argument is a tensor."""
    like = next((a for a in args if isinstance(a, torch.Tensor)), None)
    if like is None:
        return None
    return [a if isinstance(a, torch.Tensor) else _as_tensor(a, like)
            for a in args]


def _torch_call(tfn, nfn):
    """A function of the torch table: tensors through ``tfn``, an
    all-constant call through ``nfn`` in float32."""
    def call(*args):
        targs = _tensor_args(args)
        if targs is None:
            return float(nfn(*(np.float32(a) for a in args)))
        return tfn(*targs)
    return call


def _log10(x):
    return torch.log(x) / torch.log(_as_tensor(10.0, x))


_TORCH_FUNCS = {
    name: _torch_call(tfn, getattr(np, nname))
    for name, tfn, nname in (
        ("abs", torch.abs, "abs"), ("sqrt", torch.sqrt, "sqrt"),
        ("log", torch.log, "log"), ("log10", _log10, "log10"),
        ("exp", torch.exp, "exp"), ("sin", torch.sin, "sin"),
        ("cos", torch.cos, "cos"), ("tan", torch.tan, "tan"),
        ("floor", torch.floor, "floor"), ("ceil", torch.ceil, "ceil"),
        ("min", torch.minimum, "minimum"), ("max", torch.maximum, "maximum"),
        ("pow", torch.pow, "power"))}


def _twhere(c, a, b):
    if not isinstance(c, torch.Tensor):
        return a if c else b
    return torch.where(c, a, b)


def _tdiv(a, b):
    targs = _tensor_args((a, b))
    return a / b if targs is None else targs[0] / targs[1]


def _tfmod(a, b):
    targs = _tensor_args((a, b))
    if targs is None:
        return float(np.fmod(np.float32(a), np.float32(b)))
    return torch.fmod(*targs)


def _tpow(a, b):
    targs = _tensor_args((a, b))
    return a ** b if targs is None else torch.pow(*targs)


def _emit(node, env, xp):
    tag = node[0]
    if tag == "num":
        return node[1]
    if tag == "var":
        return env[node[1]]
    over_torch = xp is torch
    where = _twhere if over_torch else xp.where
    if tag == "un":
        a = _emit(node[2], env, xp)
        if node[1] == "-":
            return -a
        return where(a != 0, 0.0, 1.0)
    if tag == "bin":
        op = node[1]
        a = _emit(node[2], env, xp)
        b = _emit(node[3], env, xp)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return _tdiv(a, b) if over_torch else a / b
        if op == "%":
            # Go math.Mod semantics (truncated, sign of the dividend),
            # not Python's floored modulo
            if over_torch:
                return _tfmod(a, b)
            return xp.fmod(a, b) if hasattr(xp, "fmod") else math.fmod(a, b)
        if op == "**":
            return _tpow(a, b) if over_torch else a ** b
        if op == "==":
            return (a == b) * 1.0
        if op == "!=":
            return (a != b) * 1.0
        if op == "<":
            return (a < b) * 1.0
        if op == "<=":
            return (a <= b) * 1.0
        if op == ">":
            return (a > b) * 1.0
        if op == ">=":
            return (a >= b) * 1.0
        if op == "&&":
            return ((a != 0) & (b != 0)) * 1.0
        if op == "||":
            return ((a != 0) | (b != 0)) * 1.0
        raise ValueError(op)
    if tag == "tern":
        c = _emit(node[1], env, xp)
        a = _emit(node[2], env, xp)
        b = _emit(node[3], env, xp)
        return where(c != 0, a, b)
    if tag == "call":
        args = [_emit(n, env, xp) for n in node[2]]
        return (_TORCH_FUNCS if over_torch else _FUNCS)[node[1]](*args)
    raise ValueError(tag)


# -- structural fingerprints: the fused epilogue's key -----------------

def _normalize(node, slots: Dict[str, int], consts: List[float]):
    tag = node[0]
    if tag == "num":
        consts.append(float(node[1]))
        return ("const", len(consts) - 1)
    if tag == "var":
        if node[1] not in slots:
            slots[node[1]] = len(slots)
        return ("slot", slots[node[1]])
    if tag == "un":
        return ("un", node[1], _normalize(node[2], slots, consts))
    if tag == "bin":
        a = _normalize(node[2], slots, consts)
        b = _normalize(node[3], slots, consts)
        return ("bin", node[1], a, b)
    if tag == "tern":
        return ("tern",) + tuple(
            _normalize(n, slots, consts) for n in node[1:])
    if tag == "call":
        return ("call", node[1], tuple(
            _normalize(n, slots, consts) for n in node[2]))
    raise ValueError(tag)


@dataclass(frozen=True)
class ExprFingerprint:
    """Normalized expression structure: ``key`` the hashable normalized
    AST; ``slots`` slot index -> variable name (first-use order, equal
    to `CompiledExpr.variables`); ``consts`` the lifted literals in
    occurrence order; ``hash`` a 12-hex digest of the key."""

    key: tuple
    slots: Tuple[str, ...]
    consts: Tuple[float, ...]
    hash: str

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def const_array(self) -> np.ndarray:
        """The lifted literals as a (C,) float32 row."""
        return np.asarray(self.consts, np.float32).reshape(len(self.consts))


def _fp_eval_ast(key):
    """An `_emit` AST from a normalized key: slot i reads env["s{i}"],
    const k env["c{k}"]."""
    tag = key[0]
    if tag == "const":
        return ("var", f"c{key[1]}")
    if tag == "slot":
        return ("var", f"s{key[1]}")
    if tag == "un":
        return ("un", key[1], _fp_eval_ast(key[2]))
    if tag == "bin":
        return ("bin", key[1], _fp_eval_ast(key[2]), _fp_eval_ast(key[3]))
    if tag == "tern":
        return ("tern",) + tuple(_fp_eval_ast(n) for n in key[1:])
    if tag == "call":
        return ("call", key[1], [_fp_eval_ast(n) for n in key[2]])
    raise ValueError(tag)


def eval_fingerprint(key: tuple, planes: Sequence, consts: Sequence,
                     xp=torch):
    """Evaluate a normalized key: ``planes[i]`` feeds slot i,
    ``consts[k]`` const k (tensors broadcastable against the planes).
    The raw result; validity is the caller's."""
    env = {f"s{i}": p for i, p in enumerate(planes)}
    for k, c in enumerate(consts):
        env[f"c{k}"] = c
    return _emit(_fp_eval_ast(key), env, xp)


def fingerprint_hash(key: tuple) -> str:
    """12-hex digest of a normalized key."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


def fingerprint(ce: "CompiledExpr") -> ExprFingerprint:
    """The fingerprint of a compiled expression (cached on it)."""
    fp = ce._fp
    if fp is not None:
        return fp
    slots: Dict[str, int] = {}
    consts: List[float] = []
    key = _normalize(ce._ast, slots, consts)
    names = tuple(sorted(slots, key=slots.get))
    fp = ExprFingerprint(key, names, tuple(consts), fingerprint_hash(key))
    ce._fp = fp
    return fp


@dataclass
class CompiledExpr:
    """A parsed band expression."""

    src: str
    variables: List[str]
    _ast: tuple = field(repr=False, default=None)
    _fp: Optional[ExprFingerprint] = field(repr=False, compare=False,
                                           default=None)

    def __call__(self, env: Dict[str, object], xp=np):
        """Evaluate over the values in ``env``: numpy arrays or scalars
        (``xp=np``), or torch tensors (``xp=torch``)."""
        if xp is not np and xp is not torch:
            raise ValueError(f"unsupported array module {xp!r}")
        missing = [v for v in self.variables if v not in env]
        if missing:
            raise KeyError(f"expression {self.src!r} missing bands "
                           f"{missing}")
        return _emit(self._ast, env, xp)

    def eval_masked(self, env, valid_env, device=None):
        """Evaluate over torch tensors and combine validity: valid iff
        every referenced band is valid and the result is finite; 0.0
        elsewhere.  ``device`` places the result of a constant-only
        expression; left out, it is the device of the tensors given, or
        the card where there are none (raising without CUDA)."""
        if device is None:
            device = next((v.device for v in (*env.values(),
                                              *valid_env.values())
                           if isinstance(v, torch.Tensor)), "cuda")
        device = resolve_device(device)
        out = self(env, torch)
        if not isinstance(out, torch.Tensor):
            out = torch.tensor(float(out), dtype=torch.float32,
                               device=device)
        ok = None
        for v in self.variables:
            m = valid_env[v]
            ok = m if ok is None else (ok & m)
        if ok is None:
            ok = torch.ones(out.shape, dtype=torch.bool, device=out.device)
        # expressions can create new NaN/Inf (division by zero etc.)
        ok = ok & torch.isfinite(out)
        return torch.where(ok, out, 0.0), ok


_CACHE_CAP = 512
_cache: "OrderedDict[str, CompiledExpr]" = OrderedDict()
_cache_lock = threading.Lock()
_cache_hits = 0
_cache_misses = 0


def compile_expr(src: str) -> CompiledExpr:
    global _cache_hits, _cache_misses
    with _cache_lock:
        ce = _cache.get(src)
        if ce is not None:
            _cache.move_to_end(src)
            _cache_hits += 1
            return ce
        _cache_misses += 1
    ast = _Parser(tokenize(src)).parse()
    vars_ = []
    _collect_vars(ast, vars_)
    seen = set()
    uniq = [v for v in vars_ if not (v in seen or seen.add(v))]
    ce = CompiledExpr(src, uniq, ast)
    with _cache_lock:
        _cache.setdefault(src, ce)
        _cache.move_to_end(src)
        while len(_cache) > _CACHE_CAP:
            _cache.popitem(last=False)
        return _cache[src]


def expr_cache_stats() -> Dict[str, int]:
    """The compile cache's size and traffic, for ``/debug`` and
    ``/metrics``."""
    with _cache_lock:
        return {"size": len(_cache), "cap": _CACHE_CAP,
                "hits": _cache_hits, "misses": _cache_misses}


def reset_expr_cache() -> None:
    """Drop every cached compile and zero the counters."""
    global _cache_hits, _cache_misses
    with _cache_lock:
        _cache.clear()
        _cache_hits = 0
        _cache_misses = 0


@dataclass
class BandExpressions:
    """Parsed `rgb_products` list."""

    expressions: List[CompiledExpr]
    expr_names: List[str]          # output namespace per entry
    var_list: List[str]            # union of referenced bands (fetch list)
    expr_var_ref: List[List[str]]  # per-entry referenced bands
    expr_text: List[str]
    passthrough: bool              # all entries are bare band names


def parse_band_expressions(bands: Sequence[str]) -> BandExpressions:
    """Parse entries like ``"ndvi = (nir-red)/(nir+red)"`` or plain band
    names; ``name = expr`` binds the output namespace (at most one
    '=').  A single-part entry is a band NAME and is never parsed."""
    exprs, names, texts, var_refs = [], [], [], []
    var_list: List[str] = []
    seen = set()
    has_expr = False
    for b in bands:
        parts = [p.strip() for p in b.split("=")]
        if not parts or any(not p for p in parts):
            raise ValueError(f"invalid expression: {b!r}")
        if len(parts) == 1:
            name = body = parts[0]
            ce = CompiledExpr(body, [body], ("var", body))
        elif len(parts) == 2:
            name, body = parts[0], parts[1]
            ce = compile_expr(body)
        else:
            raise ValueError(f"invalid expression: {b!r}")
        if ce._ast[0] != "var":
            has_expr = True
        exprs.append(ce)
        names.append(name)
        texts.append(b)
        var_refs.append(list(ce.variables))
        for v in ce.variables:
            if v not in seen:
                seen.add(v)
                var_list.append(v)
    return BandExpressions(exprs, names, var_list, var_refs, texts,
                           passthrough=not has_expr)
