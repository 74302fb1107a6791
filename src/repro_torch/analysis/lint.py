"""AST lint framework over ``src/repro_torch`` (port of
``repro/analysis/lint.py``).

Rules are plain functions registered with ``@rule("id", doc)`` in
``analysis/rules/``; each receives a parsed :class:`Repo` and yields
:class:`Finding`s.  A finding at line L is suppressed by an annotation on
line L or L-1::

    # analysis: allow(<rule-id>): <one-line reason>

The reason is required: a bare ``allow(...)`` (or one with an empty
reason) suppresses nothing and is itself reported as a
``blanket-suppression`` finding, so every waiver in the tree is
individually justified.

Besides the Python modules, a ``Repo`` holds the CUDA sources under
``src/repro_torch/csrc`` as text (``Repo.csrc``), which the rules that
read the kernels (``f32-accum``) and ``kernelcheck`` parse.  A ``.cu``
file takes the same annotations in ``//`` comments.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Set

SUPPRESS_RE = re.compile(
    r"(?:#|//)\s*analysis:\s*allow\(([a-z0-9-]+)\)\s*:\s*(\S.*)$")
BLANKET_RE = re.compile(
    r"(?:#|//)\s*analysis:\s*allow\(([a-z0-9-]*)\)\s*(:?\s*)$")

SRC_REL = os.path.join("src", "repro_torch")


@dataclasses.dataclass
class Finding:
    """One analysis result, addressable as ``file:line``."""
    rule: str
    file: str                       # repo-relative path
    line: int
    message: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Module:
    """A parsed source module."""
    rel: str                        # repo-relative path
    name: str                       # import name: "repro_torch.serve.engine"
    source: str
    lines: List[str]
    tree: ast.Module


@dataclasses.dataclass
class Source:
    """A CUDA source, as text."""
    rel: str
    source: str
    lines: List[str]


def _comment_start(text: str) -> bool:
    s = text.lstrip()
    return s.startswith("#") or s.startswith("//")


class Repo:
    """Parsed view of the port's source tree (one parse per module) and
    its CUDA sources."""

    def __init__(self, root: str, src_rel: str = SRC_REL,
                 pkg_prefix: str = "repro_torch"):
        self.root = root
        self.src_rel = src_rel
        self.modules: Dict[str, Module] = {}        # by import name
        self.by_rel: Dict[str, Module] = {}
        self.csrc: Dict[str, Source] = {}           # by repo-relative path
        src = os.path.join(root, src_rel)
        for dirpath, dirnames, filenames in os.walk(src):
            dirnames[:] = sorted(d for d in dirnames
                                 if not d.startswith((".", "__pycache__")))
            for fn in sorted(filenames):
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root)
                if fn.endswith(".cu"):
                    with open(path, encoding="utf-8") as f:
                        text = f.read()
                    self.csrc[rel] = Source(rel, text, text.splitlines())
                    continue
                if not fn.endswith(".py"):
                    continue
                sub = os.path.relpath(path, src)
                parts = [p for p in sub[:-3].split(os.sep) if p]
                if parts and parts[-1] == "__init__":
                    parts = parts[:-1]
                name = ".".join([pkg_prefix] + parts) if pkg_prefix else \
                    ".".join(parts)
                with open(path, encoding="utf-8") as f:
                    source = f.read()
                mod = Module(rel=rel, name=name, source=source,
                             lines=source.splitlines(),
                             tree=ast.parse(source, filename=rel))
                self.modules[name] = mod
                self.by_rel[rel] = mod

    def lines_of(self, rel: str) -> Optional[List[str]]:
        """The lines of a module or CUDA source by repo-relative path."""
        if rel in self.by_rel:
            return self.by_rel[rel].lines
        if rel in self.csrc:
            return self.csrc[rel].lines
        return None

    @staticmethod
    def suppressions(lines: List[str]) -> Dict[int, Set[str]]:
        """Map of covered source line → suppressed rule ids.  A same-line
        annotation covers its own line; a comment-line annotation covers
        the next code line (blank lines and the rest of a multi-line
        comment block in between are skipped)."""
        out: Dict[int, Set[str]] = {}
        n = len(lines)
        for i, text in enumerate(lines, start=1):
            m = SUPPRESS_RE.search(text)
            if not m:
                continue
            covered = {i}
            if _comment_start(text):
                j = i + 1
                while j <= n and (not lines[j - 1].strip()
                                  or _comment_start(lines[j - 1])):
                    j += 1
                if j <= n:
                    covered.add(j)
            for ln in covered:
                out.setdefault(ln, set()).add(m.group(1))
        return out

    @staticmethod
    def blanket_suppressions(rel: str, lines: List[str]) -> List[Finding]:
        """Annotations with no (or an empty) reason: never honoured."""
        out = []
        for i, text in enumerate(lines, start=1):
            if BLANKET_RE.search(text):
                out.append(Finding(
                    "blanket-suppression", rel, i,
                    "allow(...) without a reason: every suppression "
                    "must carry a one-line rationale"))
        return out


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rule:
    id: str
    doc: str
    fn: Callable[[Repo], Iterable[Finding]]
    allow: Optional[str] = None     # short annotation token, if not the id


_RULES: Dict[str, Rule] = {}


def rule(rule_id: str, doc: str, allow: Optional[str] = None):
    """Register a lint rule: ``fn(repo) -> iterable of Finding``.

    ``allow`` names a short suppression token (``allow(host-sync)`` for
    ``host-sync-in-hot-path``) where the full id would be unwieldy in
    annotations; the id itself always works too."""
    def deco(fn):
        _RULES[rule_id] = Rule(rule_id, doc, fn, allow)
        return fn
    return deco


def registered_rules() -> Dict[str, Rule]:
    from repro_torch.analysis import rules as _  # noqa: F401  (registers)
    return dict(_RULES)


def run_lint(repo: Optional[Repo] = None,
             root: Optional[str] = None) -> List[Finding]:
    """Run every registered rule; drop annotated findings, keep the rest,
    and report blanket (reasonless) suppressions as findings."""
    if repo is None:
        repo = Repo(root or repo_root())
    rules = registered_rules()
    findings: List[Finding] = []
    for r in rules.values():
        findings.extend(r.fn(repo))
    out: List[Finding] = []
    sup_cache: Dict[str, Dict[int, Set[str]]] = {}
    for f in findings:
        lines = repo.lines_of(f.file)
        if lines is not None:
            if f.file not in sup_cache:
                sup_cache[f.file] = repo.suppressions(lines)
            tokens = {f.rule}
            r = rules.get(f.rule)
            if r is not None and r.allow:
                tokens.add(r.allow)
            if tokens & sup_cache[f.file].get(f.line, set()):
                continue
        out.append(f)
    for mod in repo.modules.values():
        out.extend(repo.blanket_suppressions(mod.rel, mod.lines))
    for src in repo.csrc.values():
        out.extend(repo.blanket_suppressions(src.rel, src.lines))
    return sorted(out, key=lambda f: (f.file, f.line, f.rule))


def line_of(rel: str, pattern: str) -> int:
    """Line of the first match of ``pattern`` in a repo file (0: none), to
    address a finding that is about a definition rather than a line."""
    with open(os.path.join(repo_root(), rel), encoding="utf-8") as f:
        for i, text in enumerate(f, start=1):
            if re.search(pattern, text):
                return i
    return 0


def repo_root() -> str:
    """Repository root: this file lives at src/repro_torch/analysis/lint.py."""
    here = os.path.abspath(__file__)
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))


# ---------------------------------------------------------------------------
# shared AST helpers for the rules
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` of a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def call_name(node: ast.Call) -> Optional[str]:
    """Dotted name of a call target when statically resolvable:
    ``np.asarray`` → "np.asarray", ``torch.cuda.synchronize`` →
    "torch.cuda.synchronize", ``f()`` → "f", ``x[0].item()`` → ".item"
    (leading dot = attribute on a receiver that is not a name chain)."""
    fn = node.func
    name = dotted(fn)
    if name is not None:
        return name
    if isinstance(fn, ast.Attribute):
        return f".{fn.attr}"
    return None


def from_imports(tree: ast.Module, mod_name: str,
                 is_package: bool = False) -> Dict[str, tuple]:
    """``from X import a as b`` → {"b": ("X", "a")} with relative imports
    resolved against ``mod_name``'s package (``mod_name`` itself where it
    is a package's ``__init__``)."""
    out: Dict[str, tuple] = {}
    pkg = mod_name.split(".") + ([""] if is_package else [])
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        if node.level:
            base = pkg[:len(pkg) - node.level]
            target = ".".join(base + ([node.module] if node.module else []))
        else:
            target = node.module or ""
        for alias in node.names:
            out[alias.asname or alias.name] = (target, alias.name)
    return out


def top_level_functions(tree: ast.Module) -> Dict[str, ast.AST]:
    """Top-level defs plus methods, keyed "fn" / "Class.fn"."""
    out: Dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def top_level_classes(tree: ast.Module) -> Set[str]:
    return {n.name for n in tree.body if isinstance(n, ast.ClassDef)}


class Assignments:
    """The names of a function, bound flow-insensitively: ``scan`` takes
    every ``Assign`` in line order and binds its targets (a tuple target
    element-wise against a tuple value, else each element to the whole
    value) to ``value_of(expr, line)``; ``at(name, line)`` is the value
    last bound before ``line`` (``preset``'s at line 0; None: unbound)."""

    def __init__(self, fn: ast.AST, preset: Optional[dict] = None):
        self.fn = fn
        self.bound: Dict[str, list] = {k: [(0, v)]
                                       for k, v in (preset or {}).items()}

    def scan(self, value_of) -> None:
        subs = sorted((s for s in ast.walk(self.fn)
                       if isinstance(s, ast.Assign)),
                      key=lambda s: (s.lineno, s.col_offset))
        for s in subs:
            for t in s.targets:
                self._bind(t, s.value, s.lineno, value_of)

    def _bind(self, target, value, line, value_of) -> None:
        if isinstance(target, ast.Name):
            self.bound.setdefault(target.id, []).append(
                (line, value_of(value, line)))
        elif isinstance(target, (ast.Tuple, ast.List)):
            same = isinstance(value, (ast.Tuple, ast.List)) and \
                len(value.elts) == len(target.elts)
            for i, t in enumerate(target.elts):
                self._bind(t, value.elts[i] if same else value, line,
                           value_of)

    def at(self, name: str, line: int):
        last = None
        for ln, v in self.bound.get(name, ()):
            if ln < line:
                last = v
        return last
