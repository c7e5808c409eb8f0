"""The kernel-build artifact and the warm boot on the CPU
(``analysis/factory.py``, ``obs/boot.py``, the servers' ``artifact_dir``).

The build is stubbed (``test_torch_compile.stub_build``: a library file,
no ``nvcc``). The JAX package is the oracle through its validators: the
manifest and every BOOT row pass both packages' ``validate_manifest`` and
``validate_boot_row``. Verification refuses a torn, a tampered and a
stale artifact; reconciliation itemizes ``compiled-at-boot`` and
``unmanifested``; a server and a fleet given an artifact write valid boot
rows, and one given a bad artifact writes nothing."""

import json
import os
import shutil

import pytest
import torch

from proovread_tpu.obs import validate as jvalidate
from proovread_tpu_torch.obs import validate as tvalidate
from test_torch_compile import stub_build

torch.set_num_threads(1)


@pytest.fixture
def artifact(monkeypatch, tmp_path):
    """(kernels, artifact dir): an artifact built with the stubbed build."""
    from proovread_tpu_torch.analysis import factory
    kernels = stub_build(monkeypatch, tmp_path / "build")
    art = str(tmp_path / "art")
    factory.build_artifact(art, fresh=True)
    return kernels, art


def _manifest(art):
    return json.load(open(os.path.join(art, "manifest.json")))


def test_manifest_valid_in_both_packages(artifact):
    kernels, art = artifact
    m = _manifest(art)
    for v in (tvalidate, jvalidate):
        v.validate_manifest(m)
    assert m["version"] == kernels.digest() and not m["interpret"]
    assert [p["entry"] for p in m["programs"]] == list(kernels.SOURCES)
    assert {p["persistent"] for p in m["programs"]} == {"miss"}
    assert m["programs"][0]["compile_ms"] == 10.0
    lib = kernels.library_name(kernels.digest())
    assert {p["cache_key"] for p in m["programs"]} == {lib}
    assert set(m["files"]) == {lib, lib[:-3] + ".log.json"}
    assert m["jax_version"].startswith("torch ")


@pytest.mark.parametrize("damage", ["torn", "tampered", "stale"])
def test_verify_refuses_a_damaged_artifact(artifact, damage):
    from proovread_tpu_torch.obs import boot
    kernels, art = artifact
    assert boot.verify_artifact(art)["version"] == kernels.digest()
    cache = os.path.join(art, "cache")
    lib = os.path.join(cache, kernels.library_name(kernels.digest()))
    if damage == "torn":
        with open(lib, "r+b") as fh:
            fh.truncate(10)
        want = "is 10 B"
    elif damage == "tampered":
        open(os.path.join(cache, "extra.so"), "wb").write(b"x")
        want = "unmanifested cache file"
    else:
        m = _manifest(art)
        m["version"] = "0" * 16
        json.dump(m, open(os.path.join(art, "manifest.json"), "w"))
        want = f"stale artifact.*0{{16}}.*{kernels.digest()}"
    with pytest.raises(tvalidate.ValidationError, match=want):
        boot.verify_artifact(art)
    assert boot.main(["verify", "--artifact", art]) == 1


def _report(kernels, cache_dir):
    """The boot child in this process, its build stubbed."""
    from proovread_tpu_torch.analysis import factory
    kernels._lib = None
    rep = factory.boot_report(cache_dir, device="cpu")
    assert rep["launches"] and rep["library"] is None
    # on the CPU nothing asks for the library: load it as the card would
    from proovread_tpu_torch.obs import compilecache as cc
    state = cc.cache_state()
    cc.enable_persistent_cache(cache_dir)
    try:
        with cc.scope(cc.Ledger(backend="cpu")) as led:
            kernels.lib()
    finally:
        cc.restore_cache(state)
    rep["rows"] = led.rows + rep["rows"]
    rep["census"]["backend_compiles"] = led.backend_compiles
    rep["census"]["backend_compile_s"] = round(led.backend_compile_s, 3)
    rep["census"]["persistent_hits"] = led.persistent_hits
    rep["census"]["persistent_misses"] = led.persistent_misses
    rep["library"] = os.path.basename(str(kernels.loaded_path))
    return rep


def test_boot_rows_and_reconcile(artifact, tmp_path):
    """A cold boot (empty cache: the stub builds) and an artifact boot (a
    verified copy: found built) give BOOT rows both packages accept; the
    artifact boot reconciles clean, the cold report against the manifest
    itemizes its build as compiled-at-boot, and a source or a library the
    manifest lacks is unmanifested."""
    from proovread_tpu_torch.obs import boot
    kernels, art = artifact
    manifest = boot.verify_artifact(art)
    cold = _report(kernels, str(tmp_path / "cold"))
    copy = str(tmp_path / "copy")
    boot.fetch_artifact(art, copy)
    warm = _report(kernels, copy)
    rows = {"cold": boot.boot_row("cold", cold, 3.0),
            "artifact": boot.boot_row("artifact", warm, 1.0,
                                      manifest=manifest, artifact=art)}
    for row in rows.values():
        for v in (tvalidate, jvalidate):
            v.validate_boot_row(row)
    assert rows["cold"]["persistent_misses"] == 1
    assert rows["artifact"]["hit_rate"] == 1.0
    assert rows["artifact"]["violations"] == []
    assert rows["artifact"]["n_programs"] == len(kernels.SOURCES)
    kinds = [v["kind"] for v in boot.reconcile(manifest, cold)]
    assert kinds == ["compiled-at-boot"]
    warm["programs"].append({"entry": "new.cu", "sig": "x"})
    warm["library"] = "libother.so"
    kinds = sorted(v["kind"] for v in boot.reconcile(manifest, warm))
    assert kinds == ["unmanifested", "unmanifested"]
    json.dump(cold, open(tmp_path / "r.json", "w"))
    assert boot.main(["reconcile", "--artifact", art,
                      "--report", str(tmp_path / "r.json")]) == 1


def test_server_and_fleet_boot_from_the_artifact(artifact, tmp_path):
    """``ServeConfig.artifact_dir`` writes one valid BOOT row to
    ``<state_dir>/boot.json`` and points the build directory at its
    verified copy; ``FleetConfig.artifact_dir`` fetches once and writes
    one row a replica. A bad artifact is refused before any state."""
    from proovread_tpu_torch.io.records import SeqRecord
    from proovread_tpu_torch.pipeline.driver import PipelineConfig
    from proovread_tpu_torch.serve.fleet import FleetConfig, FleetDispatcher
    from proovread_tpu_torch.serve.server import CorrectionServer, ServeConfig
    kernels, art = artifact
    srs = [SeqRecord("s0", "ACGT" * 25)]
    pcfg = PipelineConfig(device="cpu")
    st = tmp_path / "srv"
    srv = CorrectionServer(srs, ServeConfig(state_dir=str(st),
                                            artifact_dir=art), pcfg)
    assert srv.boot_manifest["version"] == kernels.digest()
    assert kernels.build_dir() == st / "artifact_cache"
    rows = [json.loads((st / "boot.json").read_text())]
    disp = FleetDispatcher(srs, FleetConfig(state_dir=str(tmp_path / "f"),
                                            n_replicas=2, artifact_dir=art),
                           pcfg)
    disp.start()
    try:
        rows += [json.loads((tmp_path / "f" / f"r{i}" / "boot.json")
                            .read_text()) for i in range(2)]
    finally:
        disp.close()
    assert [r["replica"] for r in rows] == [srv.replica_id, "r0", "r1"]
    for row in rows:
        assert row["mode"] == "artifact" and row["violations"] == []
        assert row["n_backend_compiles"] == 0
        for v in (tvalidate, jvalidate):
            v.validate_boot_row(row)
    bad = str(tmp_path / "bad")
    shutil.copytree(art, bad)
    os.remove(os.path.join(bad, "manifest.json"))
    for make in (lambda d: CorrectionServer(
            srs, ServeConfig(state_dir=d, artifact_dir=bad), pcfg),
            lambda d: FleetDispatcher(
                srs, FleetConfig(state_dir=d, artifact_dir=bad), pcfg)):
        with pytest.raises(FileNotFoundError, match="manifest.json"):
            make(str(tmp_path / "refused"))
        assert not os.path.exists(tmp_path / "refused")
