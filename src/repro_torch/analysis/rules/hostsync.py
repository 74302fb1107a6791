"""Rule ``host-sync-in-hot-path``: a host synchronization reachable from
the serving loops (port of ``repro/analysis/rules/hostsync.py``).

Flagged operations, each of which waits for the card and copies to the
host when its operand lives there:

  * ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()`` on anything;
  * ``torch.cuda.synchronize``;
  * ``float(…)``, ``int(…)`` and ``bool(…)`` of a tensor expression
    (below);
  * ``np.asarray`` and ``np.array`` (as the reference: where the operand
    is already host data the annotation says so).

A tensor expression, by a flow-insensitive scan of the function's own
assignments in line order: a ``torch.*`` call; a method called on a
tensor (other than ``.item``/``.tolist``/``.numpy``); a call of a step
(a name bound to ``….steps[…]``, or ``….steps[…](…)``); a call of
a module function one of whose returns is a tensor expression; a
subscript of, or arithmetic with, a tensor; a name last assigned one
before the line.  Anything else (parameters, attributes, comprehension
variables) is not one.

Reachability is a static call-graph closure from the roots
``Engine.run``, ``Engine.step`` and ``ServeEngine.run``: edges follow
bare-name calls (a class name reaches its ``__init__``), ``self.<method>``
calls, ``functools.partial`` targets and from-imported functions across
modules (re-exports chased), as the reference's; and, beyond it, method
calls on any receiver whose class is known: a local or ``self``
attribute bound to a constructor call (``self.kv = PagedKVCache(…)``
then ``self.kv.set_len(…)``), to a method call annotated to return a
class (``ServeTelemetry.disabled()``, ``drift.bind(…)``) or to a
parameter annotated with one (``telemetry: Optional[ServeTelemetry]``),
either branch of a conditional, and chains of such attributes
(``self.tel.drift.maybe_sample(…)``).  A step
function runs inside a CUDA-graph capture on the card, where a host sync
fails the capture loudly, so the rule needs no root there.

Intentional syncs (the step boundary, ``time_device``'s waits) carry
``# analysis: allow(host-sync): <reason>``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.lint import (Assignments, Finding, Repo,
                                       call_name, dotted, from_imports, rule,
                                       top_level_classes,
                                       top_level_functions)

RULE_ID = "host-sync-in-hot-path"

FLAGGED_DOTTED = {"np.asarray", "np.array", "torch.cuda.synchronize"}
FLAGGED_METHODS = {"item", "tolist", "cpu", "numpy"}
HOST_METHODS = {"item", "tolist", "numpy"}
SCALAR_CASTS = {"float", "int", "bool"}
STEP = "step"                       # a name bound to one of an engine's steps

HOT_ROOTS = (("repro_torch.serve.engine", "Engine.run"),
             ("repro_torch.serve.engine", "Engine.step"),
             ("repro_torch.serve.engine", "ServeEngine.run"))

FuncKey = Tuple[str, str]                   # (module name, qualname)


class _Index:
    """Call-graph index over a parsed Repo."""

    def __init__(self, repo: Repo):
        self.repo = repo
        self.funcs: Dict[FuncKey, ast.AST] = {}
        self.classes: Set[Tuple[str, str]] = set()
        self.imports: Dict[str, Dict[str, tuple]] = {}
        self.attr_types: Dict[Tuple[str, str], Dict[str, tuple]] = {}
        self.returns_tensor: Dict[FuncKey, bool] = {}
        for name, mod in repo.modules.items():
            for qual, node in top_level_functions(mod.tree).items():
                self.funcs[(name, qual)] = node
            for cls in top_level_classes(mod.tree):
                self.classes.add((name, cls))
            self.imports[name] = from_imports(
                mod.tree, name, mod.rel.endswith("__init__.py"))
        for name, mod in repo.modules.items():
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    self._self_attr_types(name, node)

    def _chase(self, mod: str, name: str, depth: int = 6):
        """(module, name) that ``name`` in ``mod`` resolves to through
        ``from X import`` chains, or None outside the tree."""
        for _ in range(depth):
            if (mod, name) in self.funcs or (mod, name) in self.classes:
                return mod, name
            imp = self.imports.get(mod, {})
            if name not in imp or imp[name][0] not in self.repo.modules:
                return None
            mod, name = imp[name]
        return None

    def resolve_name(self, mod: str, name: str) -> Optional[FuncKey]:
        """A bare-name call inside ``mod``: a function, or a class's
        ``__init__``."""
        hit = self._chase(mod, name)
        if hit is None:
            return None
        if hit in self.funcs:
            return hit
        init = (hit[0], f"{hit[1]}.__init__")
        return init if init in self.funcs else None

    def resolve_class(self, mod: str, name: str) -> Optional[tuple]:
        hit = self._chase(mod, name)
        return hit if hit in self.classes else None

    def _annotation_class(self, mod: str, ann) -> Optional[tuple]:
        """The tree class an annotation names: ``C``, ``"C"`` or
        ``Optional[C]``."""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.Subscript) and \
                dotted(ann.value) in ("Optional", "typing.Optional"):
            ann = ann.slice
        if isinstance(ann, ast.Name):
            return self.resolve_class(mod, ann.id)
        return None

    def _returns(self, c: Optional[tuple], name: str) -> Optional[tuple]:
        """The class that method ``name`` of class ``c`` is annotated to
        return."""
        node = self.funcs.get((c[0], f"{c[1]}.{name}")) if c else None
        if node is None or node.returns is None:
            return None
        return self._annotation_class(c[0], node.returns)

    def type_of(self, mod: str, e: ast.AST, scope: Dict[str, tuple],
                owner: Optional[tuple]) -> Optional[tuple]:
        """The tree class of expression ``e``: a constructor call
        ``C(…)``; a method call whose return is annotated with a class
        (``C.disabled()``, ``drift.bind(…)``); ``self`` (``owner``), a
        name in ``scope`` and an attribute of a typed receiver; either
        branch of a conditional."""
        if isinstance(e, ast.IfExp):
            return self.type_of(mod, e.body, scope, owner) or \
                self.type_of(mod, e.orelse, scope, owner)
        if isinstance(e, ast.Name):
            if e.id == "self":
                return owner
            return scope.get(e.id)
        if isinstance(e, ast.Attribute):
            recv = self.type_of(mod, e.value, scope, owner)
            return self.attr_types.get(recv, {}).get(e.attr) if recv \
                else None
        if not isinstance(e, ast.Call):
            return None
        fn = e.func
        if isinstance(fn, ast.Name):
            return self.resolve_class(mod, fn.id)
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            c = self.resolve_class(mod, recv.id) \
                if isinstance(recv, ast.Name) and recv.id not in scope \
                else None
            return self._returns(
                c or self.type_of(mod, recv, scope, owner), fn.attr)
        return None

    def _params(self, mod: str, fn: ast.AST) -> Dict[str, tuple]:
        """A function's parameters whose annotation names a class."""
        a = fn.args
        out = {}
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            c = self._annotation_class(mod, arg.annotation) \
                if arg.annotation is not None else None
            if c is not None:
                out[arg.arg] = c
        return out

    def _self_attr_types(self, mod: str, cls: ast.ClassDef) -> Dict:
        """``self.<attr>``'s class, from any method's assignments to it;
        an attribute read through another is resolved at use, so the
        owner's own attributes are filled first."""
        owner = (mod, cls.name)
        out = self.attr_types.setdefault(owner, {})
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            scope = self._params(mod, fn)
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            c = self.type_of(mod, sub.value, scope, owner)
                            if c is not None:
                                out.setdefault(t.attr, c)
        return out

    def edges(self, key: FuncKey) -> List[FuncKey]:
        """Calls out of ``key``: bare names and ``functools.partial``
        targets, and methods of any receiver whose class ``type_of``
        finds (``self``, a typed parameter or local, and attribute
        chains such as ``self.tel.drift``)."""
        mod, qual = key
        node = self.funcs[key]
        owner = (mod, qual.split(".")[0]) if "." in qual else None
        scope = self._params(mod, node)
        for sub in sorted((s for s in ast.walk(node)
                           if isinstance(s, ast.Assign)
                           and len(s.targets) == 1
                           and isinstance(s.targets[0], ast.Name)),
                          key=lambda s: s.lineno):
            c = self.type_of(mod, sub.value, scope, owner)
            if c is not None:
                scope[sub.targets[0].id] = c
        out: List[FuncKey] = []
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            cn = call_name(sub)
            if cn in ("functools.partial", "partial") and sub.args and \
                    isinstance(sub.args[0], ast.Name):
                tgt = self.resolve_name(mod, sub.args[0].id)
                if tgt:
                    out.append(tgt)
                continue
            if isinstance(fn, ast.Name):
                tgt = self.resolve_name(mod, fn.id)
                if tgt:
                    out.append(tgt)
            elif isinstance(fn, ast.Attribute):
                c = self.type_of(mod, fn.value, scope, owner)
                k = (c[0], f"{c[1]}.{fn.attr}") if c else None
                if k in self.funcs:
                    out.append(k)
        return out

    def closure(self, roots) -> Set[FuncKey]:
        seen: Set[FuncKey] = set()
        work = [r for r in roots if r in self.funcs]
        while work:
            key = work.pop()
            if key in seen:
                continue
            seen.add(key)
            work.extend(self.edges(key))
        return seen


class _Tensors:
    """Which expressions of one function are tensors (module docstring)."""

    def __init__(self, idx: _Index, key: FuncKey):
        self.idx, self.mod = idx, key[0]
        self.names = Assignments(idx.funcs[key])
        self.names.scan(lambda v, line: STEP if _is_steps(v)
                        else self.is_tensor(v, line))

    def is_tensor(self, e: ast.AST, line: int) -> bool:
        if isinstance(e, ast.Name):
            return bool(self.names.at(e.id, line))
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value, line)
        if isinstance(e, (ast.BinOp,)):
            return self.is_tensor(e.left, line) or \
                self.is_tensor(e.right, line)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand, line)
        if isinstance(e, ast.Compare):
            return any(self.is_tensor(x, line)
                       for x in [e.left] + e.comparators)
        if isinstance(e, ast.BoolOp):
            return any(self.is_tensor(x, line) for x in e.values)
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body, line) or \
                self.is_tensor(e.orelse, line)
        if not isinstance(e, ast.Call):
            return False
        fn = e.func
        name = dotted(fn)
        if name is not None and name.startswith("torch.") and \
                not name.startswith("torch.cuda."):
            return True
        if isinstance(fn, ast.Subscript):
            return _is_steps(fn)
        if isinstance(fn, ast.Name):
            if self.names.at(fn.id, line) == STEP:
                return True
            return self._returns_tensor(fn.id)
        if isinstance(fn, ast.Attribute):
            if fn.attr in HOST_METHODS:
                return False
            return self.is_tensor(fn.value, line)
        return False

    def _returns_tensor(self, name: str) -> bool:
        key = self.idx.resolve_name(self.mod, name)
        if key is None or key[1].endswith("__init__"):
            return False
        cache = self.idx.returns_tensor
        if key not in cache:
            cache[key] = False                  # a recursive call: no
            inner = _Tensors(self.idx, key)
            cache[key] = any(
                isinstance(s, ast.Return) and s.value is not None
                and inner.is_tensor(s.value, s.lineno + 1)
                for s in ast.walk(self.idx.funcs[key]))
        return cache[key]


def _is_steps(e: ast.AST) -> bool:
    """``….steps[…]``: one of an engine's steps."""
    if not isinstance(e, ast.Subscript):
        return False
    name = dotted(e.value)
    return name is not None and name.split(".")[-1] == "steps"


def _flagged(sub: ast.Call, tensors: _Tensors) -> Optional[str]:
    cn = call_name(sub)
    if cn is None:
        return None
    if cn in FLAGGED_DOTTED:
        return cn
    if "." in cn and cn.rsplit(".", 1)[1] in FLAGGED_METHODS:
        return f".{cn.rsplit('.', 1)[1]}()"
    if cn in SCALAR_CASTS and len(sub.args) == 1 and \
            tensors.is_tensor(sub.args[0], sub.lineno):
        return f"{cn}(<tensor>)"
    return None


def _scan(idx: _Index, key: FuncKey, seen_sites: Set[tuple]
          ) -> List[Finding]:
    mod = idx.repo.modules[key[0]]
    node = idx.funcs[key]
    tensors = _Tensors(idx, key)
    out = []
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        what = _flagged(sub, tensors)
        if what is None:
            continue
        site = (mod.rel, sub.lineno, sub.col_offset, sub.end_col_offset)
        if site in seen_sites:
            continue
        seen_sites.add(site)
        out.append(Finding(
            RULE_ID, mod.rel, sub.lineno,
            f"{what} in {key[1]}: reachable from the Engine.run/step and "
            "ServeEngine.run serving loops; annotate with "
            "'# analysis: allow(host-sync): <reason>' if intentional"))
    return out


def hot_closure(repo: Repo, roots=HOT_ROOTS) -> Set[FuncKey]:
    """The functions the serving loops reach."""
    return _Index(repo).closure(list(roots))


@rule(RULE_ID,
      "host sync (.item/.tolist/.cpu/.numpy, torch.cuda.synchronize, "
      "float/int/bool of a tensor, np.asarray/np.array) reachable from "
      "Engine.run/step or ServeEngine.run",
      allow="host-sync")
def check(repo: Repo) -> List[Finding]:
    idx = _Index(repo)
    findings: List[Finding] = []
    seen: Set[tuple] = set()
    for key in sorted(idx.closure(list(HOT_ROOTS))):
        findings.extend(_scan(idx, key, seen))
    return findings
