"""Port parity: the mesh rungs of the ladder and mesh-shape-invariant
output and resume, with 4 gloo ranks, held against the JAX package on the
CPU (``tests/test_dmesh_faults.py``'s end-to-end cases).

The JAX side runs in this process on conftest's 8 virtual devices; the
port side runs as 4 ranks (``parallel/launch.py``, one torch thread each)
started once by the module's ``world4`` fixture, which runs every
scenario in turn while the JAX side computes. Mesh 2 runs there too (2 of
the 4 ranks hold shards; the others keep in step and hold none).

Tolerance: exact. On the shard-exact workload, the port's mesh-2 and
mesh-4 ``Pipeline.run`` equal the JAX package's single-device run (per-read
QC records, aggregate, output records and reports byte for byte);
``device_lost@d1.p2`` at mesh 4 ends at ``mesh-dp3`` with the JAX
package's reports (the demotion notes, attributed to shard 1), its
``mesh_*`` metrics and output; a journal written at mesh 4, its last
bucket removed, resumes at mesh 2 with one replay and the same bytes.
With sampling on and bucket 0's shortcut at pass 3 (inside the span the
single-device run's fused loop draws its samples for up front), the
mesh-2 run equals the port's single-device run (held equal to the JAX
package's single-device run with sampling in
``tests/test_torch_pipeline.py``): the mesh draws passes 2..N's samples
up front too. The JAX package's own mesh run draws a sample a pass and
departs there (ROADMAP.md queue 3)."""

import glob
import os
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from proovread_tpu.obs.validate import validate_mesh_metrics as jvalidate

from proovread_tpu_torch.obs.validate import validate_mesh_metrics
from proovread_tpu_torch.parallel.launch import launch

from test_torch_dmesh import (jax_run, mesh_metrics, outcome, port_config,
                              workload)
from test_torch_pipeline import _port_records

pytestmark = pytest.mark.faults

LOST = "device_lost@d1.p2"
# sampling on, 4 iterations: bucket 0 of ``sampled_workload`` stops at
# pass 3, so one device draws one sample more than the passes it runs
SAMPLED = dict(sampling=True, n_iterations=4, device_chunk=512,
               mesh_chunks_per_shard=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs several
    workers on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sampled_workload():
    """12 reads of 600 bases, each its own segment, 30x of short reads."""
    from proovread_tpu.io.simulate import simulate_independent_segments
    longs, srs = simulate_independent_segments(seed=18, n_long=12,
                                               read_len=600, sr_per=180)
    return _port_records(longs), _port_records(srs)


def _world4(work, sampled, configs, ckpt) -> dict:
    """Every scenario on each of 4 ranks, in turn."""
    import torch.distributed as dist
    from proovread_tpu_torch.parallel import smoke
    out = {name: outcome(*smoke.run(*(sampled if name == "sampled2"
                                      else work), config=cfg))
           for name, cfg in configs.items() if name != "resume"}
    if dist.get_rank() == 0:
        ents = sorted(glob.glob(os.path.join(ckpt, "bucket_*.json")))
        out["journaled"] = len(ents)
        os.unlink(ents[-1])       # a deterministic "killed mid-run"
    dist.barrier()
    out["resume"] = outcome(*smoke.run(*work, config=configs["resume"]))
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("dmesh") / "ckpt")
    configs = {"mesh2": port_config(mesh_shards=2),
               "mesh4": port_config(mesh_shards=4),
               "lost": port_config(mesh_shards=4, fault_spec=LOST),
               "journal": port_config(mesh_shards=4, checkpoint_dir=ckpt),
               "sampled2": port_config(mesh_shards=2, **SAMPLED),
               "resume": port_config(mesh_shards=2, checkpoint_dir=ckpt,
                                     resume=True)}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(launch, 4, _world4, workload()[1],
                          sampled_workload(), configs, ckpt, device="cpu",
                          timeout=600)


@pytest.fixture(scope="module")
def base():
    """The JAX package's single-device run."""
    return jax_run(*workload()[0])


def _same_output(a: dict, b: dict) -> None:
    for key in ("recs", "agg", "untrimmed", "trimmed", "chimera"):
        assert a[key] == b[key], key


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_matches_jax_single_device(world4, base, n):
    port = world4.result()[f"mesh{n}"]
    _same_output(port, base)
    assert port["reports"] == base["reports"]
    gauges = port["metrics"]["gauges"]
    assert gauges["mesh_shards_active"]["series"][0]["value"] == n
    assert sum(s["value"] for s in port["metrics"]["counters"]
               ["mesh_passes"]["series"]) > 0


def test_device_lost_shrinks_to_mesh_dp3_as_jax(world4, base):
    jlost = jax_run(*workload()[0], mesh_shards=4, fault_spec=LOST)
    port = world4.result()["lost"]
    _same_output(port, base)
    assert port["reports"] == jlost["reports"]
    notes = [r["note"] for r in port["reports"]
             if r["task"].startswith("demote")]
    assert notes and all("shard 1" in n and "'mesh-dp3'" in n
                         for n in notes)
    assert mesh_metrics(port["metrics"]) == mesh_metrics(jlost["metrics"])
    assert validate_mesh_metrics(port["metrics"]) \
        == jvalidate(jlost["metrics"])
    faults = {tuple(sorted(s["labels"].items())): s["value"]
              for s in port["metrics"]["counters"]["mesh_faults"]["series"]}
    assert faults[(("kind", "device_lost"), ("shard", "1"))] >= 1
    assert port["metrics"]["gauges"]["mesh_rebalanced_reads"]["series"][0][
        "value"] > 0


def test_mesh4_journal_resumes_at_mesh2(world4, base):
    out = world4.result()
    assert out["journaled"] == 2
    _same_output(out["journal"], base)
    _same_output(out["resume"], base)
    replays = sum(s["value"] for s in out["resume"]["metrics"]["counters"]
                  ["checkpoint_journal_replays"]["series"])
    assert replays == 1


def test_sampled_mesh_draws_as_one_device(world4):
    from proovread_tpu_torch.parallel import smoke
    one = outcome(*smoke.run(*sampled_workload(),
                             config=port_config(**SAMPLED)))
    assert [r["task"] for r in one["reports"]] == [
        "bwa-sr-1", "bwa-sr-2", "bwa-sr-3", "bwa-sr-finish",
        "bwa-sr-1", "bwa-sr-2", "bwa-sr-finish"]
    port = world4.result()["sampled2"]
    _same_output(port, one)
    assert port["reports"] == one["reports"]
