"""The static check (port of ``proovread_tpu/analysis/__main__.py``)::

    python -m proovread_tpu_torch.analysis check [--baseline PATH]
    python -m proovread_tpu_torch.analysis baseline   # accept current debts
    python -m proovread_tpu_torch.analysis factory ...  # analysis/factory.py

``check`` runs the AST rules (``naked-timer``, ``host-sync-ast``) over
the package and exits 1 only on a violation that is not in the committed
baseline (``analysis/baseline.json``); standing debts and paid ones are
reported. The reference's jaxpr rules, its census predictor and its
budget and ledger reconciliation check XLA programs per shape, which the
port does not have (``analysis/__init__.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _violations():
    from proovread_tpu_torch.analysis import engine
    from proovread_tpu_torch.analysis import rules  # noqa: F401 (registers)
    return engine.run_ast_rules()


def cmd_check(args) -> int:
    from proovread_tpu_torch.analysis import engine
    violations = _violations()
    r = engine.ratchet(violations, engine.load_baseline(args.baseline))
    for v in r["new"]:
        print(f"STATIC-VIOLATION: {v.render()}", file=sys.stderr)
    for v in r["known"]:
        print(f"static-check: standing debt {v.key}", file=sys.stderr)
    for key in r["resolved"]:
        print(f"static-check: debt PAID — remove from baseline: {key}",
              file=sys.stderr)
    rc = 1 if r["new"] else 0
    print(json.dumps({"schema": 1, "verdict": "FAIL" if rc else "PASS",
                      "violations": {"new": [v.key for v in r["new"]],
                                     "known": [v.key for v in r["known"]],
                                     "resolved": r["resolved"]}},
                     sort_keys=True))
    print(f"static-check: {'FAIL' if rc else 'PASS'} ({len(violations)} "
          f"violation(s), {len(r['new'])} new)", file=sys.stderr)
    return rc


def cmd_baseline(args) -> int:
    from proovread_tpu_torch.analysis import engine
    violations = _violations()
    path = engine.save_baseline(violations, args.baseline)
    print(f"{len(violations)} debt(s) -> {path}", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "factory":
        from proovread_tpu_torch.analysis.factory import main as factory
        return factory(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m proovread_tpu_torch.analysis",
        description="Static checks of the port's source (AST rules, "
                    "ratcheted by a committed baseline).")
    sub = ap.add_subparsers(dest="cmd", required=True)
    chk = sub.add_parser("check", help="exit 1 on a new violation")
    chk.add_argument("--baseline", default=None)
    chk.set_defaults(fn=cmd_check)
    bl = sub.add_parser("baseline", help="rewrite the debt file from the "
                                         "current violations")
    bl.add_argument("--baseline", default=None)
    bl.set_defaults(fn=cmd_baseline)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
