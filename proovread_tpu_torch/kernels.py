"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` with ``-fmad=false`` (the Smith-Waterman kernels must round
every f32 multiply and add separately, as the JAX reference does) and
``-Xptxas -v`` (each kernel's registers, shared memory and spills, kept in
``build_log`` and read by ``ptxas_usage``), then
linked into one shared library with a plain C interface that is loaded with
``ctypes``. The library is keyed by a hash of the sources and flags, so a
fresh checkout builds it at first use and later calls reuse it. It lands in
``build/kernels/`` of the source checkout; an installed package builds into
``$XDG_CACHE_HOME`` (else ``~/.cache``) under ``proovread_tpu_torch/kernels``
instead; ``PROOVREAD_TORCH_BUILD_DIR`` overrides both, and
``set_build_dir`` (``--compile-cache``, an artifact's verified copy)
overrides that. A library found there is loaded without ``nvcc``.

``lib()``'s first call is the build window: the ``nvcc`` runs and the link
when the library was missing, or only its load when it was found. Its
seconds go to the listener set with ``set_build_listener``
(``obs/trace.py`` hands them to the span tracer, the compile ledger and
the profiler), so a run's account shows where the build landed.

Nothing here runs at import time: the CPU tests import every module.
``lib()`` builds and loads under a lock, so threads that call kernels at
once (a server's worker, a fleet's replicas) build the library once.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bsw.cu", "pileup.cu", "assemble.cu", "sw.cu", "lcs.cu",
           "scatter.cu", "edit.cu")
HEADERS = ("common.cuh",)
# each kernel entry (the public wrapper's name) -> the source it runs
ENTRY_SOURCES = {
    "bsw_expand_v2": "bsw.cu", "bsw_expand": "bsw.cu",
    "pileup_accumulate_bits": "pileup.cu",
    "pileup_accumulate_packed": "pileup.cu",
    "pileup_accumulate": "pileup.cu",
    "assemble_rows": "assemble.cu", "hcr_mask_rows": "assemble.cu",
    "sw_batch": "sw.cu", "lcs_lengths": "lcs.cu",
    "scatter_add_ordered": "scatter.cu", "edit_alignments": "edit.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes (every one returns cudaGetLastError())
_SIGNATURES = {
    "pt_bsw_expand_v2": [_P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                         _F, _F, _F, _F, _F, _F, _F, _F,
                         _P, _P, _P, _P, _P, _P, _P, _P],
    "pt_bsw_expand_v1": [_P, _P, _I, _P, _I, _I,
                         _F, _F, _F, _F, _F, _F, _F, _F,
                         _P, _P, _P, _P, _P, _P, _P, _P],
    "pt_pileup_accumulate_bits": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P,
                                  _P],
    "pt_pileup_accumulate_packed": [_P, _I, _I, _P, _P, _P, _I, _I, _P,
                                    _P],
    "pt_pileup_work_keys": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "pt_pileup_accumulate": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "pt_assemble_rows": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                         _P, _P],
    "pt_hcr_mask_rows": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                         _P],
    "pt_sw_batch": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F,
                    _P, _P, _P, _P, _P, _P],
    "pt_lcs_lengths": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                       _P, _P],
    "pt_lcs_occupancy": [_I, _P, _P],
    "pt_scatter_add_ordered": [_P, _P, _P, _P, _I, _I, _P],
    "pt_edit_alignments": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                           _P, _P],
}

_lib = None
_lib_lock = threading.Lock()
# guards every wrapper's ``launches`` count: a fleet's replica threads
# launch at once, and ``+= 1`` on a function attribute is no atomic step
_count_lock = threading.Lock()
build_seconds = None
# the nvcc runs of this process: sources compiled, and their seconds (a
# library found already built adds nothing)
nvcc_compiles = 0
nvcc_seconds = 0.0
# source name -> what nvcc printed while compiling it (ptxas's report)
build_log: dict = {}
# source name -> the wall seconds of its last nvcc run in this process,
# and the bytes of the object it made
nvcc_source_seconds: dict = {}
object_bytes: dict = {}
# the library lib() loaded, once it has; lib()'s build windows (one a
# process: the nvcc runs and the link, or the load) and their seconds
loaded_path = None
build_windows = 0
build_window_seconds = 0.0
# the directory set_build_dir chose (None: build_dir's own choice)
_build_dir_override = None
# called as listener(seconds, compiled) after lib()'s build window
_build_listener = None


class KernelBuildError(RuntimeError):
    """The kernels did not build: no ``nvcc``, or it refused a source or
    the link. The resilience ladder never absorbs it
    (``pipeline/resilience.py:classify_fault``): a cheaper rung runs the
    same kernels, so it would fail again, and nvcc's messages may carry a
    device-fault mark such as "compile"."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a CUDA error. Never absorbed by
    the resilience ladder: the error may be sticky (an illegal address
    poisons the context), and a retry would hide a kernel fault."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def set_build_dir(path) -> None:
    """Build into and load from ``path`` from now on (None: back to
    ``build_dir``'s own choice). A library this process already loaded
    stays loaded."""
    global _build_dir_override
    _build_dir_override = None if path is None else Path(path)


def set_build_listener(fn) -> None:
    """``fn(seconds, compiled)`` is called after ``lib()``'s build window
    (``compiled``: ``nvcc`` ran); None removes it."""
    global _build_listener
    _build_listener = fn


def build_dir() -> Path:
    """Where the library is built: ``set_build_dir``'s directory, else
    ``default_build_dir()``."""
    if _build_dir_override is not None:
        return _build_dir_override
    return default_build_dir()


def default_build_dir() -> Path:
    """The environment's override, else the source checkout's
    ``build/kernels``, else a per-user cache."""
    env = os.environ.get("PROOVREAD_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = SRC_DIR.parent.parent
    if (root / "pyproject.toml").exists():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "proovread_tpu_torch" / "kernels"


def _digest(src_dir: Path, names=SOURCES) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in names + HEADERS:
        h.update(name.encode())
        h.update((src_dir / name).read_bytes())
    return h.hexdigest()[:16]


def digest(src_dir: Path | None = None) -> str:
    """The library's version: a hash of every source, header and flag."""
    return _digest(Path(src_dir or SRC_DIR))


def source_digest(name: str, src_dir: Path | None = None) -> str:
    """The hash of one source (with the headers and flags)."""
    return _digest(Path(src_dir or SRC_DIR), (name,))


def library_name(version: str) -> str:
    """The library's file name for a ``digest``."""
    return f"libproovread_kernels_{version}.so"


def _nvcc_one(cmd):
    """Run one nvcc; (its output, return code, wall seconds)."""
    t0 = time.monotonic()
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return p.stdout.decode(errors="replace"), p.returncode, \
        time.monotonic() - t0


def build(src_dir: Path | None = None,
          out_dir: Path | None = None) -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library path. ``build_log`` gets nvcc's output of each
    source, saved beside the library for later loads. ``src_dir`` and
    ``out_dir`` (default: the package's sources, ``build_dir()``) let a
    tool build another copy of the sources."""
    global build_seconds, nvcc_compiles, nvcc_seconds
    src_dir = Path(src_dir or SRC_DIR)
    out_dir = Path(out_dir or build_dir())
    so = out_dir / library_name(_digest(src_dir))
    log_path = so.with_suffix(".log.json")
    if so.exists():
        if log_path.exists():
            build_log.update(json.loads(log_path.read_text()))
        return so
    t0 = time.monotonic()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [out_dir / f"{Path(name).stem}.{os.getpid()}.o"
            for name in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src_dir / name), "-o", str(obj)]
            for name, obj in zip(SOURCES, objs)]
    # one thread waits on each nvcc, so each source's own seconds are known
    with ThreadPoolExecutor(len(cmds)) as pool:
        runs = list(pool.map(_nvcc_one, cmds))
    errors, logs = [], {}
    for name, (out, code, secs) in zip(SOURCES, runs):
        logs[name] = out
        nvcc_source_seconds[name] = secs
        if code != 0:
            errors.append(f"--- {name} ---\n{logs[name]}")
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise KernelBuildError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    log_tmp = log_path.with_suffix(f".{os.getpid()}.tmp")
    log_tmp.write_text(json.dumps(logs))
    os.replace(log_tmp, log_path)
    os.replace(tmp, so)
    for name, obj in zip(SOURCES, objs):
        object_bytes[name] = obj.stat().st_size
        obj.unlink(missing_ok=True)
    build_log.update(logs)
    build_seconds = time.monotonic() - t0
    nvcc_compiles += len(SOURCES)
    nvcc_seconds += build_seconds
    return so


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers(?:, used \d+ barriers)?"
                         r"(?:, (\d+) bytes smem)?")


def ptxas_usage(source: str) -> dict:
    """Registers, static shared memory and spills of each kernel of
    ``source`` (a name in ``SOURCES``), from ptxas's report in
    ``build_log``: {kernel: {"registers", "smem_bytes", "stack_bytes",
    "spill_stores", "spill_loads"}}. A kernel's name is its demangled
    name and template arguments (``sw_kernel<20>``) where ``c++filt`` is
    installed, else the mangled one."""
    usage, fn = {}, None
    for line in build_log.get(source, "").splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            fn = m.group(1)
            usage[fn] = {}
            continue
        if fn is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            usage[fn].update(stack_bytes=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m:
            usage[fn].update(registers=int(m.group(1)),
                             smem_bytes=int(m.group(2) or 0))
    filt = shutil.which("c++filt")
    if filt and usage:
        names = subprocess.run([filt], input="\n".join(usage), text=True,
                               capture_output=True).stdout.splitlines()
        if len(names) == len(usage):
            short = [re.search(r"(\w+(?:<[^()]*>)?)\((?!anonymous)", nm)
                     for nm in names]
            usage = {(m.group(1) if m else nm): u for m, nm, u in
                     zip(short, names, usage.values())}
    return usage


def load(path: Path) -> ctypes.CDLL:
    """A built library, loaded, with every C entry's argtypes set."""
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.pt_error_string.argtypes = [ctypes.c_int]
    handle.pt_error_string.restype = ctypes.c_char_p
    return handle


def lib():
    """The loaded kernel library (built on first call, once however many
    threads ask at the same time). The build window goes to the build
    listener."""
    global _lib, loaded_path, build_windows, build_window_seconds
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                t0 = time.monotonic()
                n0 = nvcc_compiles
                path = build()
                handle = load(path)
                seconds = time.monotonic() - t0
                loaded_path, _lib = path, handle
                build_windows += 1
                build_window_seconds += seconds
                if _build_listener is not None:
                    _build_listener(seconds, nvcc_compiles > n0)
    return _lib


def census() -> dict:
    """What this process built and loaded: the CUDA sources in the loaded
    library (0 before the first launch, and on the CPU), the sources
    ``nvcc`` compiled and its seconds."""
    return {"n_programs": len(SOURCES) if _lib is not None else 0,
            "nvcc_compiles": nvcc_compiles,
            "nvcc_seconds": round(nvcc_seconds, 6)}


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().pt_error_string(rc).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {rc} ({msg})")


def count_launch(fn) -> None:
    """Add one to ``fn.launches``: a wrapper calls it once its kernel
    launched, and nowhere else."""
    with _count_lock:
        fn.launches += 1


def require(cond: bool, msg: str) -> None:
    """Validate a wrapper's arguments before pointers reach native code
    (a check that raises, not an assert, so it survives ``python -O``)."""
    if not cond:
        raise ValueError(msg)


def require_in_range(what: str, *checks) -> None:
    """Raise unless every (int tensor, lo, hi, name) has all values in
    [lo, hi]: index arrays the kernel dereferences. One ``aminmax`` per
    tensor, then one device sync for all of them."""
    import torch
    live = [c for c in checks if c[0].numel()]
    if not live:
        return
    ext = torch.stack([v for c in live for v in torch.aminmax(c[0])]).tolist()
    for i, (_, lo, hi, name) in enumerate(live):
        mn, mx = ext[2 * i], ext[2 * i + 1]
        require(lo <= mn and mx <= hi,
                f"{what}: {name} outside [{lo}, {hi}] (min {mn}, max {mx})")


def stream_of(t) -> int:
    """The current CUDA stream handle of ``t``'s device, as an int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream

