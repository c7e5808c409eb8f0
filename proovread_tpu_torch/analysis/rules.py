"""The static-check rules (port of ``proovread_tpu/analysis/rules.py``,
its AST rules).

- ``naked-timer``: no bare ``time.time()`` in ``pipeline/``, ``obs/`` or
  the CLI: every duration comes from the tracer's monotonic clock.
- ``host-sync-ast``: in the hot-path functions (:data:`HOST_SYNC_SCOPE`,
  the counterparts of the reference's, and the CUDA launch paths of the
  kernel wrappers), no ``.item()``, ``.tolist()``, ``.cpu()``, and no
  ``int()`` / ``float()`` / ``bool()`` of a computed value: each waits
  for the device when its operand is a CUDA tensor. A site that is host
  arithmetic by construction carries ``# static-ok: <reason>``; a real
  sync that stays is a debt in ``baseline.json``, with its reason.

The reference's five jaxpr rules have no counterpart, because each walks
a traced XLA program and the port runs PyTorch eagerly:

- ``no-gather`` holds the fused chunk scans free of XLA ``gather``
  equations; the port's chunk loop is Python over hand-written kernels,
  with no XLA lowering to hold;
- ``donation`` checks a jit's ``donate_argnums`` against declared
  argument lifetimes; eager PyTorch frees a tensor when its last
  reference goes, and has no donation to declare;
- ``host-sync`` (on jaxprs) finds callback primitives and per-chunk
  ``device_put`` inside a traced scan; eager code has no traced program,
  and its syncs are what ``host-sync-ast`` finds in the source;
- ``wide-dtype`` finds x64 values in a traced program (a jax mode
  switch); PyTorch has no such mode, each tensor's dtype is explicit;
- ``packed-upcast`` finds large int8/u32 to f32 converts inside a traced
  chunk scan; there is no traced scan to look in.
"""

from __future__ import annotations

import ast
import os
from typing import List

from proovread_tpu_torch.analysis.engine import (ScopedVisitor, Violation,
                                                 ast_rule, parse_module)

# the naked-timer rule's scope
NAKED_TIMER_SCOPE = ("pipeline", "obs", "cli.py")


class _NakedTimerVisitor(ScopedVisitor):
    def visit_Call(self, node):
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr == "time"
                and isinstance(f.value, ast.Name)
                and f.value.id == "time"):
            self.record("time.time()", node)
        self.generic_visit(node)


@ast_rule("naked-timer")
def rule_naked_timer(root: str) -> List[Violation]:
    """Every duration from the tracer's monotonic clock: no bare
    ``time.time()``."""
    out: List[Violation] = []
    for target in NAKED_TIMER_SCOPE:
        tpath = os.path.join(root, target)
        files = ([tpath] if tpath.endswith(".py") else
                 sorted(os.path.join(tpath, f) for f in os.listdir(tpath)
                        if f.endswith(".py")))
        for path in files:
            rel = os.path.relpath(path, root)
            tree, _lines, ok_lines = parse_module(path)
            v = _NakedTimerVisitor(rel, ok_lines)
            v.visit(tree)
            out.extend(Violation(
                "naked-timer", f"{rel}::{scope}", detail,
                f"bare time.time() at {rel}:{line} — use obs.span / "
                "time.monotonic()")
                for scope, detail, line, _pat in v.hits)
    return out


# module relpath -> the functions to scan (qualified by def chain; nested
# functions included), or None for every function of the module: the
# counterparts of the reference's HOST_SYNC_SCOPE, and the CUDA launch
# path of each kernel wrapper
HOST_SYNC_SCOPE = {
    "pipeline/dcorrect.py": [
        "DeviceCorrector.correct_pass", "_fused_pass_scanned",
        "_fused_pass_unrolled", "_fused_pass", "fused_iterations",
        "_gather_and_align", "device_assemble", "device_hcr_mask",
        "device_admit", "_pad_candidates"],
    "parallel/dmesh.py": [
        "compile_step_with_plan", "build_sharded_step",
        "sharded_iteration_step"],
    "align/bsw.py": ["bsw_expand", "bsw_expand_v2", "_bsw_cuda",
                     "_bsw_v1_cuda", "build_map_pad", "window_starts"],
    "align/dseed.py": ["build_index", "probe_candidates",
                       "compact_candidates", "_probe_slab"],
    "ops/pileup_kernel.py": ["pileup_accumulate",
                             "pileup_accumulate_packed",
                             "pileup_accumulate_bits", "_cols_cuda",
                             "_dense_cuda"],
    "ops/assemble_kernel.py": ["assemble_rows", "hcr_mask_rows",
                               "assemble_fields_cuda", "hcr_mask_cuda"],
    "ops/fused.py": ["fused_accumulate", "add_ref_votes"],
    "ops/consensus_call.py": ["call_consensus"],
    "ops/scatter.py": ["scatter_add_ordered", "_scatter_cuda"],
    "kernels.py": ["require_in_range"],
}

# tensor methods that wait for the device and copy to the host
_SYNC_METHODS = ("item", "tolist", "cpu")


class _HostSyncVisitor(ScopedVisitor):
    """Flags device-to-host syncs in the hot-path functions.
    ``int()`` / ``float()`` / ``bool()`` are flagged for computed
    operands only (a name, attribute or call; not ``len()``)."""

    def __init__(self, relpath, ok_lines, fn_filter):
        super().__init__(relpath, ok_lines)
        self.fn_filter = fn_filter

    def in_scope(self) -> bool:
        if self.fn_filter is None:
            return bool(self.stack)
        scope = self.scope()
        return any(scope == f or scope.startswith(f + ".")
                   for f in self.fn_filter)

    def visit_Call(self, node):
        if self.in_scope():
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS
                    and not node.args):
                self.record(f".{f.attr}()", node)
            elif (isinstance(f, ast.Name) and f.id in ("int", "float",
                                                       "bool")
                    and len(node.args) == 1
                    and isinstance(node.args[0],
                                   (ast.Name, ast.Attribute, ast.Call))
                    and not (isinstance(node.args[0], ast.Call)
                             and isinstance(node.args[0].func, ast.Name)
                             and node.args[0].func.id == "len")):
                self.record(f"{f.id}()", node)
        self.generic_visit(node)


@ast_rule("host-sync-ast")
def rule_host_sync_ast(root: str) -> List[Violation]:
    out: List[Violation] = []
    for rel, fns in sorted(HOST_SYNC_SCOPE.items()):
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            out.append(Violation(
                "host-sync-ast", rel, "missing-module",
                "hot-path module named in HOST_SYNC_SCOPE does not exist "
                "— update the scope"))
            continue
        tree, _lines, ok_lines = parse_module(path)
        v = _HostSyncVisitor(rel, ok_lines, fns)
        v.visit(tree)
        out.extend(Violation(
            "host-sync-ast", f"{rel}::{scope}", detail,
            f"{pat} at {rel}:{line} — a device-to-host sync in the hot "
            "path; fetch values batched at pass boundaries, or mark a "
            "host-by-construction site '# static-ok: <reason>'")
            for scope, detail, line, pat in v.hits)
    return out
