"""Rule ``f32-accum``: every product of the kernels and of their plain
versions accumulates in f32 (the port's counterpart of
``repro/analysis/rules/f32accum.py``, which requires each Pallas
contraction to declare f32).

The port's numerics contract (token identity across MAC backends, dense
vs paged parity, kernel against plain version) hangs on f32 sums.  Two
checks:

  * **the CUDA kernels**: every ``mma.sync`` instruction string in a
    string literal of ``csrc/*.cu`` must name f32 D and C types, as
    ``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` (the shape,
    the layouts, then the D, A, B and C types).  A literal naming
    ``mma.sync`` that does not parse so is a finding too.
  * **the plain versions**: in every function of ``kernels/ref.py`` and
    every ``*_plain`` function of ``kernels/*.py``, each operand of a
    product (``torch.einsum``, ``torch.matmul``, ``torch.mm``,
    ``torch.bmm``, ``@``) must be an f32 expression.  The AST test: an
    expression is f32 when it is ``….to(torch.float32)`` / ``.to(f32)``
    / ``.to(dtype=…float32)`` / ``.float()``; a ``torch.*`` call with
    ``dtype=`` f32, or an elementwise ``torch.*`` call (``exp``,
    ``where``, ``maximum``, ``tanh``, …) one of whose arguments is f32; a
    shape or reduction method (``reshape``, ``permute``, ``transpose``,
    ``sum``, ``amax``, …) or a subscript of an f32 expression; arithmetic
    with an f32 operand (type promotion keeps it f32); a conditional both
    of whose branches are f32; a call of a function of the tree (the
    module's own or from-imported) all of whose returns are f32 with its
    parameters bound to its arguments; or a name whose last assignment
    before the line is f32.  ``f32`` names ``torch.float32`` where the
    function assigns it so.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from repro_torch.analysis.lint import (Assignments, Finding, Repo, dotted,
                                       from_imports, rule)

RULE_ID = "f32-accum"

MMA_LITERAL_RE = re.compile(r'"([^"]*mma\.sync[^"]*)"')
MMA_RE = re.compile(r"mma\.sync\.aligned\.m\d+n\d+k\d+\.(?:row|col)\."
                    r"(?:row|col)\.(\w+)\.(\w+)\.(\w+)\.(\w+)")

PRODUCTS = {"torch.einsum", "torch.matmul", "torch.mm", "torch.bmm"}
SHAPE_METHODS = {"reshape", "view", "permute", "transpose", "t",
                 "contiguous", "expand", "unsqueeze", "squeeze", "flatten",
                 "clone", "narrow", "sum", "amax", "max", "min", "mean",
                 "repeat_interleave", "masked_fill", "clamp_min", "exp",
                 "abs", "neg", "tanh"}
ELEMENTWISE = {"torch.exp", "torch.where", "torch.maximum", "torch.minimum",
               "torch.tanh", "torch.clamp_min", "torch.clamp", "torch.abs",
               "torch.log", "torch.sqrt", "torch.rsqrt"}
PLAIN_DIRS = ("src/repro_torch/kernels/",)


def check_csrc(rel: str, lines: List[str]) -> List[Finding]:
    """Every ``mma.sync`` literal of one CUDA source names f32 D and C."""
    out = []
    for i, text in enumerate(lines, start=1):
        for lit in MMA_LITERAL_RE.findall(text):
            m = MMA_RE.search(lit)
            if m is None:
                out.append(Finding(
                    RULE_ID, rel, i,
                    f"mma.sync literal '{lit.strip()}' does not parse as "
                    "mma.sync.aligned.mMnNkK.<layout>.<layout>.D.A.B.C"))
                continue
            d, _, _, c = m.groups()
            if d != "f32" or c != "f32":
                out.append(Finding(
                    RULE_ID, rel, i,
                    f"mma.sync accumulates in {d} (D) / {c} (C), not f32: "
                    f"'{lit.strip()}'"))
    return out


def _is_f32_dtype(e: ast.AST, env_f32_names) -> bool:
    name = dotted(e)
    return name in ("torch.float32", "torch.float") or (
        isinstance(e, ast.Name) and e.id in env_f32_names)


class _F32:
    """Which expressions of one function are f32 (module docstring)."""

    def __init__(self, repo: Repo, mod_name: str, fn: ast.AST,
                 params: Optional[Dict[str, bool]] = None, depth: int = 0):
        self.repo, self.mod, self.depth = repo, mod_name, depth
        self.dtype_names = {
            s.targets[0].id for s in ast.walk(fn)
            if isinstance(s, ast.Assign) and len(s.targets) == 1
            and isinstance(s.targets[0], ast.Name)
            and dotted(s.value) in ("torch.float32", "torch.float")}
        self.names = Assignments(fn, params)
        self.names.scan(self.f32)             # reads self.names as it binds

    def f32(self, e: ast.AST, line: int) -> bool:
        if isinstance(e, ast.Name):
            return bool(self.names.at(e.id, line))
        if isinstance(e, ast.Subscript):
            return self.f32(e.value, line)
        if isinstance(e, ast.BinOp):
            return self.f32(e.left, line) or self.f32(e.right, line)
        if isinstance(e, ast.UnaryOp):
            return self.f32(e.operand, line)
        if isinstance(e, ast.IfExp):
            return self.f32(e.body, line) and self.f32(e.orelse, line)
        if not isinstance(e, ast.Call):
            return False
        fn = e.func
        name = dotted(fn)
        kw = {k.arg: k.value for k in e.keywords}
        if isinstance(fn, ast.Attribute):
            if fn.attr == "float" and not e.args:
                return True
            if fn.attr == "to":
                dt = e.args[0] if e.args else kw.get("dtype")
                return dt is not None and _is_f32_dtype(dt, self.dtype_names)
            if fn.attr in SHAPE_METHODS and not (name or "").startswith(
                    "torch."):
                return self.f32(fn.value, line)
        if name is not None and name.startswith("torch."):
            if "dtype" in kw:
                return _is_f32_dtype(kw["dtype"], self.dtype_names)
            if name in ELEMENTWISE:
                return any(self.f32(a, line) for a in e.args)
            return False
        if isinstance(fn, ast.Name):
            return self._call_returns_f32(fn.id, e, line)
        return False

    def _call_returns_f32(self, name: str, call: ast.Call, line) -> bool:
        if self.depth >= 4:
            return False
        hit = _resolve(self.repo, self.mod, name)
        if hit is None:
            return False
        mod_name, node = hit
        args = node.args.args
        params = {a.arg: self.f32(v, line)
                  for a, v in zip(args, call.args)}
        for k in call.keywords:
            if k.arg is not None:
                params[k.arg] = self.f32(k.value, line)
        inner = _F32(self.repo, mod_name, node, params, self.depth + 1)
        rets = [s for s in ast.walk(node)
                if isinstance(s, ast.Return) and s.value is not None]
        return bool(rets) and all(inner.f32(s.value, s.lineno + 1)
                                  for s in rets)


def _module_funcs(tree: ast.Module) -> Dict[str, ast.AST]:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _resolve(repo: Repo, mod_name: str, name: str):
    """(module, FunctionDef) of a bare name in ``mod_name``."""
    for _ in range(6):
        mod = repo.modules.get(mod_name)
        if mod is None:
            return None
        funcs = _module_funcs(mod.tree)
        if name in funcs:
            return mod_name, funcs[name]
        imp = from_imports(mod.tree, mod_name,
                           mod.rel.endswith("__init__.py"))
        if name not in imp:
            return None
        mod_name, name = imp[name]
    return None


def _products(fn: ast.AST):
    """(node, operand expressions) of every product in ``fn``."""
    for sub in ast.walk(fn):
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.MatMult):
            yield sub, [sub.left, sub.right]
        elif isinstance(sub, ast.Call) and dotted(sub.func) in PRODUCTS:
            ops = sub.args
            if dotted(sub.func) == "torch.einsum":
                ops = ops[1:]
            yield sub, list(ops)


def plain_functions(repo: Repo):
    """(module, FunctionDef) of every plain version: each function of
    ``kernels/ref.py`` and each ``*_plain`` function under kernels/."""
    for mod in repo.modules.values():
        rel = mod.rel.replace("\\", "/")
        if not rel.startswith(PLAIN_DIRS):
            continue
        for name, node in _module_funcs(mod.tree).items():
            if rel.endswith("/ref.py") or name.endswith("_plain"):
                yield mod, node


def check_plain(repo: Repo) -> List[Finding]:
    out = []
    for mod, fn in plain_functions(repo):
        env = _F32(repo, mod.name, fn)
        for node, ops in _products(fn):
            for i, op in enumerate(ops):
                if not env.f32(op, node.lineno):
                    out.append(Finding(
                        RULE_ID, mod.rel, node.lineno,
                        f"{fn.name}: operand {i} of a product "
                        f"('{ast.unparse(op)}') is not an f32 expression "
                        "(cast it with .to(torch.float32))"))
    return out


@rule(RULE_ID, "every mma.sync in csrc/*.cu accumulates in f32 (D and C "
               "types), and every product of a plain version takes f32 "
               "operands")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    for src in repo.csrc.values():
        out.extend(check_csrc(src.rel, src.lines))
    out.extend(check_plain(repo))
    return out
