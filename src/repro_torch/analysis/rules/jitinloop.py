"""Rule ``jit-in-loop``: a CUDA-graph capture, or a kernel build or
library load, inside a ``for``/``while`` body (the port's counterpart of
``repro/analysis/rules/jitinloop.py``).

A graph is captured once per step shape and replayed
(``serve/graphs.py``: an engine keeps one ``Step`` per step function); a
kernel library is built and loaded once (``kernels/build.py``, each
wrapper's cached ``_launcher``).  Flagged inside a loop body:
``torch.cuda.graph(…)``, ``torch.cuda.CUDAGraph(…)``, a new ``Step(…)``
(``graphs.Step``), and ``build.build(…)``, ``build.load(…)`` or
``ctypes.CDLL(…)``.  Each would capture or compile again per iteration;
hoist it out of the loop or cache it.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.lint import Finding, Repo, call_name, rule

RULE_ID = "jit-in-loop"

CAPTURES = {"torch.cuda.graph", "torch.cuda.CUDAGraph", "Step",
            "graphs.Step"}
BUILDS = {"build.build", "build.load", "ctypes.CDLL", "CDLL"}


def flagged(node: ast.Call) -> Optional[str]:
    cn = call_name(node)
    if cn in CAPTURES:
        return "a CUDA-graph capture"
    if cn in BUILDS:
        return "a kernel build or library load"
    return None


@rule(RULE_ID, "CUDA-graph capture (torch.cuda.graph, CUDAGraph, "
               "graphs.Step) or kernel build/load inside a for/while loop "
               "body (captures or compiles every iteration)")
def check(repo: Repo) -> List[Finding]:
    out: List[Finding] = []
    seen = set()
    for mod in repo.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
                continue
            for stmt in node.body + node.orelse:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    what = flagged(sub)
                    site = (mod.rel, sub.lineno, sub.col_offset,
                            sub.end_col_offset)
                    if what is None or site in seen:
                        continue
                    seen.add(site)
                    out.append(Finding(
                        RULE_ID, mod.rel, sub.lineno,
                        f"{what} ({call_name(sub)}) inside a loop body: "
                        "hoist it out, or keep one per shape as the "
                        "engine's step cache does"))
    return out
