"""Rule ``metric-docs-sync``: the metrics the port registers and the
metric tables that document them name the same set (port of
``repro/analysis/rules/metricdocs.py``).

Registrations are ``….counter("name", …)`` / ``.gauge`` / ``.histogram``
calls with a literal first argument anywhere under ``src/repro_torch``.
Documentation is any backticked ``metric_name`` in the first cell of a
markdown table row of ``docs/observability.md`` (the reference's metric
tables, read and never edited) or of the README's port section between
``<!-- port-metrics -->`` and ``<!-- /port-metrics -->`` (the names the
port registers beyond that doc).  Rows may group several names.

Both directions are findings: an undocumented registration points at its
line; a name documented in the README's port table but never registered
points at its row.  A name of ``docs/observability.md`` that the port
does not register is a finding as well, unless the README's port section
lists it under ``<!-- port-unregistered -->`` … ``<!--
/port-unregistered -->`` with its reason.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Tuple

from repro_torch.analysis.lint import Finding, Repo, rule

RULE_ID = "metric-docs-sync"
DOC_REL = os.path.join("docs", "observability.md")
README_REL = "README.md"
PORT_TABLE = ("<!-- port-metrics -->", "<!-- /port-metrics -->")
PORT_UNREGISTERED = ("<!-- port-unregistered -->",
                     "<!-- /port-unregistered -->")
_KINDS = ("counter", "gauge", "histogram")
_NAME_RE = re.compile(r"`([a-z][a-z0-9_]*)`")


def registered_metrics(repo: Repo) -> Dict[str, tuple]:
    """metric name → (file, line) of its first registration."""
    out: Dict[str, tuple] = {}
    for mod in repo.modules.values():
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _KINDS and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            out.setdefault(node.args[0].value, (mod.rel, node.lineno))
    return out


def _table_names(path: str, rel: str, span=None) -> Dict[str, Tuple]:
    """name → (rel, line) of the first cells of the table rows of
    ``path`` (inside ``span``'s two markers when given)."""
    out: Dict[str, tuple] = {}
    if not os.path.exists(path):
        return out
    inside = span is None
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, start=1):
            if span is not None:
                if span[0] in line:
                    inside = True
                    continue
                if span[1] in line:
                    inside = False
                    continue
            if not inside or not line.lstrip().startswith("|"):
                continue
            # only the first (name) column: later columns hold prose that
            # may backtick flags or other identifiers
            first_cell = line.split("|")[1] if line.count("|") >= 2 else ""
            for m in _NAME_RE.finditer(first_cell):
                out.setdefault(m.group(1), (rel, i))
    return out


def documented_metrics(repo: Repo) -> Tuple[Dict, Dict, Dict]:
    """(the reference doc's names, the README port table's names, the
    README's list of reference names the port does not register)."""
    readme = os.path.join(repo.root, README_REL)
    return (_table_names(os.path.join(repo.root, DOC_REL), DOC_REL),
            _table_names(readme, README_REL, PORT_TABLE),
            _table_names(readme, README_REL, PORT_UNREGISTERED))


@rule(RULE_ID, "every metric the port registers appears in "
               "docs/observability.md's tables or the README's port "
               "metric table, and vice versa")
def check(repo: Repo) -> List[Finding]:
    reg = registered_metrics(repo)
    doc, port, unregistered = documented_metrics(repo)
    out: List[Finding] = []
    for name in sorted(set(reg) - set(doc) - set(port)):
        f, ln = reg[name]
        out.append(Finding(
            RULE_ID, f, ln,
            f"metric '{name}' is registered here but has no row in "
            f"{DOC_REL} or the README's port metric table"))
    for name in sorted(set(port) - set(reg)):
        f, ln = port[name]
        out.append(Finding(
            RULE_ID, f, ln,
            f"metric '{name}' is documented in the README's port table "
            "but never registered in src/repro_torch"))
    for name in sorted(set(doc) - set(reg) - set(unregistered)):
        f, ln = doc[name]
        out.append(Finding(
            RULE_ID, f, ln,
            f"metric '{name}' is documented here but never registered "
            "in src/repro_torch"))
    return out
