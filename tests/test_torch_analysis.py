"""The port's static checks (``proovread_tpu_torch/analysis``) and its
shape oracle, on the CPU.

The JAX package's AST rule functions are the oracle: run on the same
synthetic sources (each package's scope pointed at them), the reference's
``rule_naked_timer`` and ``rule_host_sync_ast`` give the same violation
keys as the port's on the patterns both look for (``time.time()``,
``.item()``, ``int()`` / ``float()`` / ``bool()`` of a computed value,
the ``# static-ok:`` opt-out, nested scopes). ``python -m
proovread_tpu_torch.analysis check`` exits 0 on the tree as committed,
and ``analysis/shapes.py``'s config-4 bucket table equals the
reference's."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from proovread_tpu.analysis import engine as jengine
from proovread_tpu.analysis import rules as jrules
from proovread_tpu_torch.analysis import engine as tengine
from proovread_tpu_torch.analysis import rules as trules

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

HOT = '''
import time


def hot(x, n):
    t0 = time.time()
    a = x.item()
    b = int(x.sum())
    c = float(n)
    d = int(len(n))                 # host arithmetic: not flagged
    e = bool(x)  # static-ok: a host flag
    # static-ok: the whole statement below is host-side
    f = int(x)

    def inner():
        return float(x.max()), x.item()
    return t0, a, b, c, d, e, f, inner


def cold(x):
    return x.item(), time.time()


class K:
    def hot(self, x):
        return int(x), time.time()
'''


def _tree(tmp_path):
    (tmp_path / "pipeline").mkdir()
    (tmp_path / "obs").mkdir()
    (tmp_path / "pipeline" / "mod.py").write_text(HOT)
    (tmp_path / "obs" / "clean.py").write_text("import time\n"
                                               "t = time.monotonic()\n")
    (tmp_path / "cli.py").write_text(HOT)
    return str(tmp_path)


@pytest.mark.parametrize("rule", ["naked-timer", "host-sync-ast"])
def test_rules_agree_with_the_reference(tmp_path, monkeypatch, rule):
    root = _tree(tmp_path)
    scope = {"pipeline/mod.py": ["hot", "K.hot"], "missing.py": None}
    for mod in (jrules, trules):
        monkeypatch.setattr(mod, "HOST_SYNC_SCOPE", scope)
        monkeypatch.setattr(mod, "NAKED_TIMER_SCOPE",
                            ("pipeline", "obs", "cli.py"))
    fn = {"naked-timer": "rule_naked_timer",
          "host-sync-ast": "rule_host_sync_ast"}[rule]
    got = sorted(v.key for v in getattr(trules, fn)(root))
    want = sorted(v.key for v in getattr(jrules, fn)(root))
    assert got == want and got
    if rule == "host-sync-ast":
        assert "host-sync-ast::pipeline/mod.py::hot::bool()#0" not in got
        assert "host-sync-ast::pipeline/mod.py::hot.inner::float()#0" in got
        assert not any("::cold::" in k for k in got)


def test_port_rules_flag_torch_syncs(tmp_path, monkeypatch):
    """The port's host-sync rule also flags ``.tolist()`` and ``.cpu()``
    (torch's device-to-host copies); the ratchet splits new, known and
    paid debts."""
    (tmp_path / "m.py").write_text(
        "def hot(x):\n    return x.tolist(), x.cpu(), x.cuda()\n")
    monkeypatch.setattr(trules, "HOST_SYNC_SCOPE", {"m.py": ["hot"]})
    keys = [v.key for v in trules.rule_host_sync_ast(str(tmp_path))]
    assert keys == ["host-sync-ast::m.py::hot::.tolist()#0",
                    "host-sync-ast::m.py::hot::.cpu()#0"]
    vs = trules.rule_host_sync_ast(str(tmp_path))
    r = tengine.ratchet(vs, {"violations": {keys[0]: "known",
                                            "gone": "paid"}})
    assert [v.key for v in r["new"]] == [keys[1]]
    assert [v.key for v in r["known"]] == [keys[0]]
    assert r["resolved"] == ["gone"]
    assert jengine.ratchet(vs, {"violations": {keys[0]: "known",
                                               "gone": "paid"}}) == r


def test_check_exits_zero_on_the_committed_tree():
    """Every standing debt is in the baseline with its reason, and none is
    paid and left there."""
    out = subprocess.run(
        [sys.executable, "-m", "proovread_tpu_torch.analysis", "check"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert '"verdict": "PASS"' in out.stdout
    assert "debt PAID" not in out.stderr
    base = tengine.load_baseline()
    assert base["violations"] and all(
        len(reason) > 40 for reason in base["violations"].values())


def test_config4_bucket_table_equals_the_reference():
    from proovread_tpu.analysis.shapes import build_plan as jplan
    from proovread_tpu_torch.analysis.shapes import build_plan as tplan
    j, t = jplan(4), tplan(4)
    assert [(b.n_reads, b.rows, b.Lp, b.pad) for b in t.buckets] == \
        [(b.n_reads, b.rows, b.Lp, b.pad) for b in j.buckets]
    assert (t.n_short, t.m, t.min_sr_len) == (j.n_short, j.m, j.min_sr_len)
    assert t.coverage == pytest.approx(j.coverage, rel=1e-12)
