"""Start the ranks of a mesh run: N processes of one program on gloo.

The JAX package needs no launcher: one process drives every device. The
port runs one process per shard (``parallel/dmesh.py``), and
:func:`launch` starts them:

* N ranks with the ``spawn`` start method (``fork`` is unsafe in a
  process that has threads, and CUDA cannot be forked);
* each joins a gloo process group through a ``FileStore`` in a temporary
  directory, not a TCP port, so concurrent launches (test workers, a
  server's fleet) cannot clash;
* each sets its device, ``cuda:{rank % device_count}`` (so ranks may
  share one card), or on the CPU pins one intra-op thread (N ranks'
  torch kernels spreading over every core would slow each other many
  times over);
* the kernel library is built once in the parent before the ranks start
  (``kernels.build()`` needs no CUDA context), so ranks do not race
  ``nvcc``.

When one rank dies (an exception, a signal), every other rank is torn
down at once, so no orphan holds the card or waits on a collective; a
rank also dies with its parent (``PR_SET_PDEATHSIG`` where Linux offers
it). :func:`launch` returns rank 0's result or raises :class:`RankFailed`
naming the rank that failed first.

Under ``torchrun`` the ranks already exist: :func:`init_from_env` joins
the group its environment describes.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import shutil
import signal
import sys
import tempfile
import time
import traceback
from typing import Any, Optional

# seconds a torn-down rank gets between SIGTERM and SIGKILL
_GRACE = 5.0
# seconds any collective of a launch's default group may wait (torch's own
# default for gloo)
GROUP_TIMEOUT_S = 1800.0


class RankFailed(RuntimeError):
    """A rank of a launch exited with an error or was killed."""

    def __init__(self, rank: Optional[int], exitcode: Optional[int],
                 detail: str = ""):
        self.rank = rank
        self.exitcode = exitcode
        self.detail = detail
        how = (f"killed by signal {-exitcode}" if exitcode and exitcode < 0
               else f"exit code {exitcode}")
        what = (f"rank {rank} failed ({how})" if rank is not None
                else "the ranks did not finish in time")
        super().__init__(what + (f":\n{detail}" if detail else ""))


def _die_with_parent(parent: int) -> None:
    """Ask Linux to SIGKILL this process when its parent dies; exit now if
    the parent is already gone."""
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)      # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def _set_device(rank: int, device: str) -> None:
    import torch
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())


def _rank_main(rank: int, n: int, tmp: str, device: str, parent: int, fn,
               args) -> None:
    _die_with_parent(parent)
    import torch.distributed as dist
    try:
        _set_device(rank, device)
        store = dist.FileStore(os.path.join(tmp, "store"), n)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        res = fn(*args)
        if rank == 0:
            path = os.path.join(tmp, "result.pkl")
            with open(path + ".tmp", "wb") as fh:
                pickle.dump(res, fh)
            os.replace(path + ".tmp", path)
    except BaseException:                           # noqa: BLE001
        # record what failed and leave at once: a rank whose collective is
        # still pending in gloo's threads must not wait for it at exit
        tb = traceback.format_exc()
        try:
            with open(os.path.join(tmp, f"error.{rank}"), "w") as fh:
                json.dump({"time": time.time(), "traceback": tb}, fh)
        finally:
            print(f"rank {rank}:\n{tb}", end="", flush=True,
                  file=sys.stderr)
            os._exit(1)
    dist.destroy_process_group()


def _teardown(procs) -> None:
    live = [p for p in procs if p.exitcode is None]
    for p in live:
        p.terminate()
    t_end = time.monotonic() + _GRACE
    for p in live:
        p.join(max(0.0, t_end - time.monotonic()))
    for p in live:
        if p.exitcode is None:
            p.kill()
            p.join()


def _first_failure(procs, tmp: str):
    """(rank, exitcode, detail) of the rank that failed first. A rank
    killed by a signal comes first (no other rank's failure kills one; a
    rank that raised may be raising because a peer's sockets closed), then
    the earliest error its record states."""
    best = None
    for r, p in enumerate(procs):
        if p.exitcode in (None, 0):
            continue
        at, detail = float("inf"), ""
        try:
            with open(os.path.join(tmp, f"error.{r}")) as fh:
                rec = json.load(fh)
            at, detail = rec["time"], rec["traceback"]
        except (OSError, ValueError, KeyError):
            pass
        key = (p.exitcode >= 0, at, r)
        if best is None or key < best[0]:
            best = (key, r, p.exitcode, detail)
    return best[1:]


def launch(n: int, fn, *args, device: str = "cuda",
           timeout: Optional[float] = None) -> Any:
    """Run ``fn(*args)`` on ``n`` ranks of a gloo group and return rank
    0's result. ``fn`` and ``args`` must pickle (``fn`` a module-level
    function). ``device`` is ``cuda`` or ``cpu``; ``timeout`` bounds the
    whole launch (seconds, None: unbounded). Raises :class:`RankFailed`
    naming the first rank that failed, once every rank is down."""
    import multiprocessing as mp
    if n < 1:
        raise ValueError(f"launch needs at least one rank, not {n}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if device == "cuda":
        from proovread_tpu_torch import kernels
        from proovread_tpu_torch.device import resolve
        resolve(device)
        kernels.build()
    tmp = tempfile.mkdtemp(prefix="proovread_ranks_")
    ctx = mp.get_context("spawn")
    procs = []
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for r in range(n):
            p = ctx.Process(target=_rank_main, name=f"proovread-rank{r}",
                            args=(r, n, tmp, device, os.getpid(), fn,
                                  args))
            p.start()
            procs.append(p)
        while True:
            if any(p.exitcode not in (None, 0) for p in procs):
                rank, code, detail = _first_failure(procs, tmp)
                _teardown(procs)
                raise RankFailed(rank, code, detail)
            if all(p.exitcode == 0 for p in procs):
                break
            if deadline is not None and time.monotonic() > deadline:
                _teardown(procs)
                raise RankFailed(None, None,
                                 f"launch timed out after {timeout} s")
            time.sleep(0.05)
        with open(os.path.join(tmp, "result.pkl"), "rb") as fh:
            return pickle.load(fh)
    finally:
        _teardown(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def init_from_env(device: str = "cuda") -> bool:
    """Join the process group ``torchrun`` describes in the environment
    (``WORLD_SIZE`` > 1; rank, address and port from its variables), on
    gloo, and set this rank's device from ``LOCAL_RANK``. Returns whether
    a group was joined."""
    import torch.distributed as dist
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) < 2:
        return False
    _set_device(int(os.environ.get("LOCAL_RANK", 0)), device)
    dist.init_process_group("gloo")
    return True
