"""The port stands alone: no ``jax`` and no ``proovread_tpu`` imports, CUDA
asked for without a card raises, unsupported settings raise
``NotImplementedError`` naming the setting, and the resilience settings
(the journal, resume, a bucket timeout, fault injection, the scan engine)
run."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "proovread_tpu_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "proovread_tpu")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path}: imports {bad}"


def test_port_import_leaves_jax_unloaded():
    code = ("import sys\n"
            "import proovread_tpu_torch.pipeline.driver, "
            "proovread_tpu_torch.state, proovread_tpu_torch.kernels, "
            "proovread_tpu_torch.cli, "
            "proovread_tpu_torch.pipeline.siamaera, "
            "proovread_tpu_torch.obs, proovread_tpu_torch.obs.accuracy, "
            "proovread_tpu_torch.obs.memory, proovread_tpu_torch.obs.qc, "
            "proovread_tpu_torch.io.simulate, "
            "proovread_tpu_torch.testing.faults, "
            "proovread_tpu_torch.pipeline.resilience, "
            "proovread_tpu_torch.pipeline.correct, "
            "proovread_tpu_torch.ops.fused\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'proovread_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _tiny():
    from proovread_tpu_torch.io.records import SeqRecord
    rng = np.random.default_rng(0)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 400))
    longs = [SeqRecord("r0", g[:300])]
    srs = [SeqRecord(f"s{i}", g[i:i + 100], qual=np.full(100, 30, np.uint8))
           for i in range(0, 300, 20)]
    return longs, srs


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from proovread_tpu_torch.device import resolve
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    with pytest.raises(RuntimeError, match="cuda"):
        resolve("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        Pipeline(PipelineConfig()).run(*_tiny())


@pytest.mark.parametrize("setting,kw", [
    ("engine", dict(engine="host")),
    ("mode", dict(mode="utg")),
    ("mesh_shards", dict(mesh_shards=2)),
    ("haplo_coverage", dict(haplo_coverage=0.0)),
    ("debug_dir", dict(debug_dir="dbg")),
    ("sr_device_budget", dict(sr_device_budget=10)),
])
def test_unsupported_settings_raise(setting, kw):
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    cfg = PipelineConfig(device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=setting):
        Pipeline(cfg).run(*_tiny())


@pytest.mark.parametrize("kw", [
    dict(engine="scan"), dict(checkpoint_dir="ckpt"),
    dict(checkpoint_dir="ckpt", resume=True), dict(bucket_timeout=600.0),
    dict(fault_spec="oom@b9"), dict(ladder=False, fault_spec="")],
    ids=["scan", "checkpoint_dir", "resume", "bucket_timeout", "fault",
         "no_ladder"])
def test_resilience_settings_run(tmp_path, kw):
    """The resilience settings and the scan engine run on the CPU and
    correct the read, with no demotion."""
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    if "checkpoint_dir" in kw:
        kw = {**kw, "checkpoint_dir": str(tmp_path / kw["checkpoint_dir"])}
    res = Pipeline(PipelineConfig(device="cpu", n_iterations=2,
                                  device_chunk=128, host_chunk_rows=512,
                                  **kw)).run(*_tiny())
    assert [r.id for r in res.untrimmed] == ["r0"]
    assert not any(r.task.startswith("demote") for r in res.reports)


def test_kernel_build_dir(monkeypatch, tmp_path):
    from proovread_tpu_torch import kernels
    monkeypatch.delenv("PROOVREAD_TORCH_BUILD_DIR", raising=False)
    assert kernels.build_dir() == ROOT / "build" / "kernels"
    monkeypatch.setenv("PROOVREAD_TORCH_BUILD_DIR", str(tmp_path))
    assert kernels.build_dir() == tmp_path
    # an installed package (no pyproject.toml above it) builds per user
    monkeypatch.delenv("PROOVREAD_TORCH_BUILD_DIR")
    monkeypatch.setattr(kernels, "SRC_DIR", tmp_path / "pkg" / "csrc")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert kernels.build_dir() == (tmp_path / "cache" / "proovread_tpu_torch"
                                   / "kernels")


def test_kernel_wrappers_raise_on_other_devices():
    from proovread_tpu_torch.ops.assemble_kernel import hcr_mask_rows
    q = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    ln = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        hcr_mask_rows(q, ln, [20, 41, 80, 130, 60, 0.7])
