"""The rule engine: AST rule registry, violations, baseline ratchet (port
of ``proovread_tpu/analysis/engine.py``, its AST half).

**AST rules** run over source files: each rule declares its own file and
function scope and walks the parsed AST. A line may opt out with an
inline ``# static-ok: <reason>`` comment (a site that looks like a
violation but is host-side by construction); real debts belong in the
baseline instead, where they stay visible.

**The ratchet** (:func:`ratchet`): violations are keyed
``rule::where::detail``, with no line numbers, so unrelated edits keep
the baseline valid. ``check`` fails only on violations not in the
committed ``analysis/baseline.json``; baselined debts are reported as
standing debt, and baseline entries that no longer fire are reported so
the file can be ratcheted down.

The reference's jaxpr half (tracing entry points, walking their jaxprs)
has no counterpart: PyTorch runs eagerly, there is no program to walk.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

BASELINE_SCHEMA = 1

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json")


@dataclass(frozen=True)
class Violation:
    """One contract breach. ``where`` is ``<relpath>::<qualified fn>``;
    ``detail`` a stable discriminator (pattern and ordinal), never a line
    number. ``message`` is not part of the identity."""
    rule: str
    where: str
    detail: str
    message: str = ""

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.where}::{self.detail}"

    def render(self) -> str:
        msg = f" — {self.message}" if self.message else ""
        return f"[{self.rule}] {self.where} ({self.detail}){msg}"


# name -> fn(root: str) -> List[Violation]
AST_RULES: Dict[str, Callable] = {}


def ast_rule(name: str):
    def deco(fn):
        fn.rule_name = name
        AST_RULES[name] = fn
        return fn
    return deco


def run_ast_rules(root: Optional[str] = None,
                  rules: Optional[List[str]] = None) -> List[Violation]:
    root = root or _PKG_ROOT
    out: List[Violation] = []
    for name in (rules or AST_RULES):
        out.extend(AST_RULES[name](root))
    return out


STATIC_OK_MARK = "static-ok:"


def parse_module(path: str):
    """(ast tree, source lines, the static-ok line numbers). A trailing
    ``# static-ok:`` waives its own line; one in a comment block waives
    the first code line below the block."""
    with open(path) as fh:
        src = fh.read()
    lines = src.splitlines()
    ok_lines = set()
    for i, ln in enumerate(lines):
        if STATIC_OK_MARK not in ln:
            continue
        ok_lines.add(i + 1)
        if not ln.strip().startswith("#"):
            continue
        j = i + 1
        while j < len(lines) and lines[j].strip().startswith("#"):
            j += 1
        if j < len(lines):
            ok_lines.add(j + 1)
    return ast.parse(src), lines, ok_lines


class ScopedVisitor(ast.NodeVisitor):
    """Tracks the enclosing def/class chain (the stable ``where``) and an
    ordinal per (scope, pattern)."""

    def __init__(self, relpath: str, ok_lines):
        self.relpath = relpath
        self.ok_lines = ok_lines
        self.stack: List[str] = []
        self._ordinals: Dict[Tuple[str, str], int] = {}
        self.hits: List[Tuple[str, str, int, str]] = []

    def scope(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def record(self, pattern: str, node: ast.AST) -> None:
        line = getattr(node, "lineno", 0)
        if line in self.ok_lines:
            return
        scope = self.scope()
        k = (scope, pattern)
        i = self._ordinals.get(k, 0)
        self._ordinals[k] = i + 1
        self.hits.append((scope, f"{pattern}#{i}", line, pattern))

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()


def load_baseline(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or DEFAULT_BASELINE
    if not os.path.exists(path):
        return {"schema": BASELINE_SCHEMA, "violations": {}}
    with open(path) as fh:
        data = json.load(fh)
    if data.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"baseline {path}: schema {data.get('schema')!r} "
                         f"!= {BASELINE_SCHEMA}")
    return data


def save_baseline(violations: List[Violation],
                  path: Optional[str] = None) -> str:
    """Rewrite the debt file from the current violations (the explicit
    'accept these debts' step), keeping each known entry's reason."""
    path = path or DEFAULT_BASELINE
    old = load_baseline(path).get("violations", {}) \
        if os.path.exists(path) else {}
    vmap = {v.key: old.get(v.key) or v.message
            for v in sorted(violations, key=lambda v: v.key)}
    with open(path, "w") as fh:
        json.dump({"schema": BASELINE_SCHEMA, "violations": vmap}, fh,
                  indent=1, sort_keys=True)
        fh.write("\n")
    return path


def ratchet(violations: List[Violation],
            baseline: Dict[str, Any]) -> Dict[str, Any]:
    """``new`` (fails the check), ``known`` (standing debt) and
    ``resolved`` (baseline entries that no longer fire)."""
    known_keys = baseline.get("violations", {})
    fired = {v.key for v in violations}
    return {"new": [v for v in violations if v.key not in known_keys],
            "known": [v for v in violations if v.key in known_keys],
            "resolved": sorted(k for k in known_keys if k not in fired)}
