"""Multi-device parallelism: the data-parallel mesh over the ranks of a
``torch.distributed`` group (port of ``proovread_tpu/parallel``).

The reference's outermost parallelism is share-nothing job-level chunking
of the long-read set; here each rank corrects a shard of every bucket's
long reads, with the short reads replicated on every rank's device. Every
rank runs the SAME correction pass the single-device pipeline runs; the
only traffic between ranks is the passes' integer KPI sums and, once a
bucket, the gathered read state (``dmesh.py``). ``launch.py`` starts the
ranks; ``plan.py`` places the reads; ``smoke.py`` is the fault drill.
The reference's ``compat.py`` (where jax keeps ``shard_map``) has no
counterpart.
"""

from proovread_tpu_torch.parallel.dmesh import (
    build_sharded_step,
    compile_step_with_plan,
    make_dp_mesh,
    sharded_iteration_step,
)
from proovread_tpu_torch.parallel.plan import (
    balance_placement,
    moved_reads,
    shard_of_rows,
)

__all__ = ["balance_placement", "build_sharded_step",
           "compile_step_with_plan", "make_dp_mesh", "moved_reads",
           "shard_of_rows", "sharded_iteration_step"]
