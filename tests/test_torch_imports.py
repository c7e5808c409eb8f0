"""The port stands alone: no ``jax`` and no ``proovread_tpu`` imports (the
serving layer, the validators, the mesh, the compile ledger, the cost
attribution, the boot and the static checks included), CUDA asked for
without a card raises, threads that ask for the kernel library at once
build it once, unsupported settings raise ``NotImplementedError`` naming
the setting, a mesh without a process group clamps to one device, and the
resilience settings
(the journal, resume, a bucket timeout, fault injection, the scan engine),
flex mode (``haplo_coverage`` bare and explicit), the streaming regime and
``debug_dir`` run."""

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
                         + [ROOT / "chip_smoke.py",
                            ROOT / "tools" / "kernel_probe.py"],
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
            "proovread_tpu_torch.ops.fused, proovread_tpu_torch.ops.scatter, "
            "proovread_tpu_torch.ops.pileup, "
            "proovread_tpu_torch.consensus.engine, "
            "proovread_tpu_torch.pipeline.ccs, "
            "proovread_tpu_torch.pipeline.utg, "
            "proovread_tpu_torch.pipeline.tasks, "
            "proovread_tpu_torch.io.sam, proovread_tpu_torch.ops.variants, "
            "proovread_tpu_torch.pipeline.sam2cns, "
            "proovread_tpu_torch.pipeline.dazz2sam, "
            "proovread_tpu_torch.tools, proovread_tpu_torch.obs.validate, "
            "proovread_tpu_torch.obs.smoke, proovread_tpu_torch.obs.load, "
            "proovread_tpu_torch.serve, proovread_tpu_torch.serve.protocol, "
            "proovread_tpu_torch.serve.jobs, "
            "proovread_tpu_torch.serve.admission, "
            "proovread_tpu_torch.serve.batcher, "
            "proovread_tpu_torch.serve.server, "
            "proovread_tpu_torch.serve.cli, "
            "proovread_tpu_torch.serve.fleet, "
            "proovread_tpu_torch.serve.loadgen, "
            "proovread_tpu_torch.serve.smoke, "
            "proovread_tpu_torch.parallel, "
            "proovread_tpu_torch.parallel.plan, "
            "proovread_tpu_torch.parallel.dmesh, "
            "proovread_tpu_torch.parallel.launch, "
            "proovread_tpu_torch.parallel.smoke, "
            "proovread_tpu_torch.obs.compilecache, "
            "proovread_tpu_torch.obs.profile, "
            "proovread_tpu_torch.obs.census, proovread_tpu_torch.obs.boot, "
            "proovread_tpu_torch.analysis, "
            "proovread_tpu_torch.analysis.engine, "
            "proovread_tpu_torch.analysis.rules, "
            "proovread_tpu_torch.analysis.shapes, "
            "proovread_tpu_torch.analysis.factory, "
            "proovread_tpu_torch.analysis.__main__\n"
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
])
def test_unsupported_settings_raise(setting, kw):
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    cfg = PipelineConfig(device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=setting):
        Pipeline(cfg).run(*_tiny())


def test_mesh_without_group_clamps_to_one_device(caplog):
    """``mesh_shards=2`` in a process of no ``torch.distributed`` group
    clamps to one device with the reference's warning (its clamp to the
    devices it sees), and the run equals the single-device run."""
    import logging
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    kw = dict(device="cpu", n_iterations=2, device_chunk=128,
              host_chunk_rows=512)
    with caplog.at_level(logging.WARNING, logger="proovread_tpu_torch"):
        res = Pipeline(PipelineConfig(mesh_shards=2, **kw)).run(*_tiny())
    assert "clamping mesh_shards 2 -> 1" in caplog.text
    one = Pipeline(PipelineConfig(**kw)).run(*_tiny())

    def key(r):
        return [(x.id, x.seq, bytes(x.qual)) for x in r.untrimmed], [
            (x.task, x.masked_frac, x.n_candidates) for x in r.reports]
    assert key(res) == key(one)
    assert not res.metrics["counters"]["mesh_passes"]["series"]


@pytest.mark.parametrize("kw", [
    dict(engine="scan"), dict(checkpoint_dir="ckpt"),
    dict(checkpoint_dir="ckpt", resume=True), dict(bucket_timeout=600.0),
    dict(fault_spec="oom@b9"), dict(ladder=False, fault_spec=""),
    dict(haplo_coverage=-1.0), dict(haplo_coverage=12.0),
    dict(sr_device_budget=10), dict(debug_dir="dbg")],
    ids=["scan", "checkpoint_dir", "resume", "bucket_timeout", "fault",
         "no_ladder", "flex", "flex_cutoff", "streaming", "debug_dir"])
def test_resilience_settings_run(tmp_path, kw):
    """The resilience settings, the scan engine, flex mode, a short-read
    set over its device budget (streamed) and ``debug_dir`` run on the
    CPU and correct the read, with no demotion."""
    from proovread_tpu_torch.pipeline.driver import Pipeline, PipelineConfig
    for key in ("checkpoint_dir", "debug_dir"):
        if key in kw:
            kw = {**kw, key: str(tmp_path / kw[key])}
            os.makedirs(kw[key], exist_ok=True)
    res = Pipeline(PipelineConfig(device="cpu", n_iterations=2,
                                  device_chunk=128, host_chunk_rows=512,
                                  **kw)).run(*_tiny())
    assert [r.id for r in res.untrimmed] == ["r0"]
    assert not any(r.task.startswith("demote") for r in res.reports)
    if "debug_dir" in kw:
        assert os.listdir(kw["debug_dir"]) == ["admitted.r0.sam"]


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


def test_kernel_library_builds_once_across_threads(monkeypatch):
    """Threads that call ``kernels.lib()`` at once (a server's worker, a
    fleet's replicas) build and load the library once; the build is
    stubbed (no nvcc here) and slow enough that the threads overlap."""
    import threading
    import time

    from proovread_tpu_torch import kernels
    calls = []

    def build():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return "lib.so"

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels, "load", lambda path: ("loaded", path))
    start = threading.Barrier(8)
    got = []

    def worker():
        start.wait(timeout=10)
        got.append(kernels.lib())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert got == [("loaded", "lib.so")] * 8


def test_kernel_census_counts_this_process(monkeypatch):
    """The census the SLO artifact reports: no program before the library
    is loaded, the sources of the loaded library after."""
    from proovread_tpu_torch import kernels
    monkeypatch.setattr(kernels, "_lib", None)
    assert kernels.census()["n_programs"] == 0
    monkeypatch.setattr(kernels, "_lib", object())
    monkeypatch.setattr(kernels, "nvcc_compiles", 7)
    monkeypatch.setattr(kernels, "nvcc_seconds", 3.25)
    assert kernels.census() == {"n_programs": len(kernels.SOURCES),
                                "nvcc_compiles": 7, "nvcc_seconds": 3.25}


def test_launch_counts_exact_across_threads():
    """Replica threads that launch at once lose no count: each
    ``kernels.count_launch`` adds one under the counts' lock."""
    import sys
    import threading

    from proovread_tpu_torch import kernels

    def fn():
        pass
    fn.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)            # switch threads as often as can be
    try:
        start = threading.Barrier(8)

        def worker():
            start.wait(timeout=10)
            for _ in range(5000):
                kernels.count_launch(fn)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 8 * 5000
