"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` with ``-fmad=false`` (the Smith-Waterman kernels must round
every f32 multiply and add separately, as the JAX reference does), then
linked into one shared library with a plain C interface that is loaded with
``ctypes``. The library is keyed by a hash of the sources and flags, so a
fresh checkout builds it at first use and later calls reuse it. It lands in
``build/kernels/`` of the source checkout; an installed package builds into
``$XDG_CACHE_HOME`` (else ``~/.cache``) under ``proovread_tpu_torch/kernels``
instead, and ``PROOVREAD_TORCH_BUILD_DIR`` overrides both.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bsw.cu", "pileup.cu", "assemble.cu", "sw.cu", "lcs.cu",
           "scatter.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

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
    "pt_lcs_lengths": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "pt_lcs_occupancy": [_I, _P, _P],
    "pt_scatter_add_ordered": [_P, _P, _P, _P, _I, _P],
}

_lib = None
build_seconds = None


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


def build_dir() -> Path:
    """Where the library is built: the override, else the source checkout's
    ``build/kernels``, else a per-user cache."""
    env = os.environ.get("PROOVREAD_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = SRC_DIR.parent.parent
    if (root / "pyproject.toml").exists():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "proovread_tpu_torch" / "kernels"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library path."""
    global build_seconds
    out_dir = build_dir()
    so = out_dir / f"libproovread_kernels_{_digest()}.so"
    if so.exists():
        return so
    t0 = time.monotonic()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = out_dir / f"{Path(name).stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(SRC_DIR / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objs.append(obj)
    errors = []
    for name, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"--- {name} ---\n{out.decode(errors='replace')}")
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
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.monotonic() - t0
    return so


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.pt_error_string.argtypes = [ctypes.c_int]
        handle.pt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().pt_error_string(rc).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {rc} ({msg})")


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

