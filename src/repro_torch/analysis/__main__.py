"""The analysis runner: lint + kernel plans + sharding coverage +
captured-step audit + the seeded-mutation self-test (port of
``scripts/analyze.py``).

    PYTHONPATH=src python -m repro_torch.analysis    # lint, kernels, sharding
    PYTHONPATH=src python -m repro_torch.analysis --self-test
    PYTHONPATH=src python -m repro_torch.analysis --compiled  # CPU rules
    PYTHONPATH=src python -m repro_torch.analysis --kernels --sms 132
    PYTHONPATH=src python -m repro_torch.analysis --json report.json

Findings print one a line as ``file:line: [rule] message``; with
``--json`` they and each checker's coverage go to a structured report.
Any finding or self-test escape exits 1.  With no selection flag the
three source-level checks run.  Everything here runs on the CPU
(``--compiled`` spawns two gloo ranks for its collective table);
``chip_smoke.py``'s phase 11 runs the same checks beside the card and the
captured-step rules on the card.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis")
    ap.add_argument("--lint", action="store_true",
                    help="AST lint rules over src/repro_torch and csrc")
    ap.add_argument("--kernels", action="store_true",
                    help="kernel-plan, constant and launcher-ABI checks")
    ap.add_argument("--sharding", action="store_true",
                    help="sharding-coverage checker")
    ap.add_argument("--compiled", action="store_true",
                    help="captured-step audit on the CPU: capture counts, "
                         "purity, donation, TP 2 collectives")
    ap.add_argument("--self-test", action="store_true",
                    help="seeded-mutation escape check (each planted "
                         "defect must be caught)")
    ap.add_argument("--sms", type=int, action="append", default=None,
                    help="SM count(s) the kernel plans are checked at "
                         "(default: 132, 114, 78, 16)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the structured report here")
    ap.add_argument("--rules", action="store_true",
                    help="print the lint-rule catalog and exit")
    args = ap.parse_args(argv)

    if args.rules:
        from repro_torch.analysis.lint import registered_rules
        for r in registered_rules().values():
            tok = f" (allow: {r.allow})" if r.allow else ""
            print(f"{r.id}{tok}: {r.doc}")
        return 0

    run_all = not (args.lint or args.kernels or args.sharding
                   or args.compiled or args.self_test)
    report = {"findings": [], "coverage": {}, "selftest": []}
    findings = []
    if args.lint or run_all:
        from repro_torch.analysis.lint import run_lint
        f = run_lint()
        findings += f
        report["coverage"]["lint"] = {"findings": len(f)}
    if args.kernels or run_all:
        from repro_torch.analysis.kernelcheck import SMS, run_kernelcheck
        f, cov = run_kernelcheck(tuple(args.sms or SMS))
        findings += f
        report["coverage"]["kernels"] = cov
        k1, k2 = cov["kernel1"], cov["kernel2"]
        print(f"kernels: {k1['plans']} kernel-1 plans over "
              f"{k1['linear_shapes']} linear shapes, {k2['geometries']} "
              f"kernel-2 geometries, sms {k1['sms']}")
        for rec in cov["constants"]:
            print(f"kernels: constant {rec['python']} = {rec['cuda']} "
                  f"{'checked' if rec['ok'] else 'MISMATCH'}")
        for rec in cov["launchers"]:
            print(f"kernels: launcher {rec['python']} = {rec['cuda']} "
                  f"({rec['arity']} args) "
                  f"{'checked' if rec['ok'] else 'MISMATCH'}")
    if args.sharding or run_all:
        from repro_torch.analysis.shardcheck import run_shardcheck
        f, cov = run_shardcheck()
        findings += f
        report["coverage"]["sharding"] = cov
        print(f"sharding: meshes {cov['meshes']}, served {cov['served']}, "
              f"trained {cov['trained']}, refused {sorted(cov['refused'])}")
    if args.compiled:
        from repro_torch.analysis.compiled import run_compiled
        f, rep = run_compiled()
        findings += f
        report["coverage"]["compiled"] = rep
        caps = {k: v["captures"] for k, v in rep["traces"].items()}
        print(f"compiled: captures {caps}; collectives "
              f"{rep['collectives']['steps']}")

    escapes = []
    if args.self_test:
        from repro_torch.analysis.selftest import run_selftest
        report["selftest"] = run_selftest()
        escapes = [r for r in report["selftest"] if not r["caught"]]
        for r in report["selftest"]:
            tag = "caught" if r["caught"] else "ESCAPE"
            err = f"  ({r['error']})" if r.get("error") else ""
            print(f"selftest {tag:6s} {r['case']}{err}")

    report["findings"] = [f.to_json() for f in findings]
    for f in findings:
        print(f)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fp:
            json.dump(report, fp, indent=2, sort_keys=True, default=str)
        print(f"report -> {args.json}")
    print(f"analysis: {len(findings)} finding(s)"
          + (f", {len(escapes)} self-test escape(s)" if args.self_test
             else ""))
    return 1 if (findings or escapes) else 0


if __name__ == "__main__":
    sys.exit(main())
