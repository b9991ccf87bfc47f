"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ``ctypes``.

Every ``kernels/csrc/*.cu`` is compiled for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, and linked into one shared
library with a plain C interface.  The library goes into
``kernels/.build/<hash of the sources and flags>/``, a directory that
``.gitignore`` lists, so an edited source gets a fresh build and an
unchanged one is loaded as it is.  Nothing is built at import: the first
kernel launch builds, and a machine without ``nvcc`` gets an error there.

Each C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launches (the ring's stream waits
and writes, the driver's ``CUresult``); ``check`` raises when that is not
0.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / ".build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
# C signatures: name -> argument types (every entry point returns int)
SIGNATURES = {
    # zwin, w0, eps, wout, M, tau, K, D, then the plan (vq_fused._window_plan:
    # resident (0/1), threads, rows, rows in shared memory, stride4, smem
    # bytes), stream
    "vq_window_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P),
    # threads, smem bytes, register rows (0/1), int* out: 8-block clusters
    # the card holds at once
    "vq_window_clusters": (_I, _I, _I, _P),
    # z, w, counts, zsum, mind, assign, pmin, pidx, tickets, M, B, K, D,
    # kchunk, stream (pmin, pidx and tickets: vq_assign.argmin_plan's
    # scratch)
    "vq_delta_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _P),
    # z, w, mind, assign, pmin, pidx, tickets, M, B, K, D, kchunk, stream
    "vq_assign_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # full, vals, idx, residual, M, N, k, slice length (vq_fused._topk_plan),
    # stream
    "vq_topk_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # z, w, residual, counts, zsum, delta, mind, assign, pmin, pidx,
    # tickets, M, B, K, D, kchunk, bk, stream (residual and delta may be
    # NULL)
    "vq_delta_blocked_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _I, _P),
    # x, mask, out, M, N, stream (mask may be NULL)
    "vq_ring_f32": (_P, _P, _P, _I, _L, _P),
    # a, b, partial, tickets, out, M, N, G (blocks a worker), stream
    "vq_divergence_f32": (_P, _P, _P, _P, _P, _I, _L, _I, _P),
    # the ring between processes (vq_ring_hop.cu), on staging allocations
    # (a counter, then the row; every pointer below is an allocation's
    # base): int[2] out, the card's 64-bit stream memory operations and
    # remote-write flush (0/1); a row's bytes and void** out; free; export
    # (base, 64-byte handle out); open (handle, void** out); close; one
    # step (left, its wait value, right, its wait value (0: no wait),
    # flush 0/1, x, mask or NULL, N, M, chunk index or -1 for the stage,
    # chunk length, add 0/1, mine, its counter's new value, stream); one
    # hop alone (left, mine, chunk index, chunk length, add 0/1, stream);
    # copy (dst, mine, N, stream)
    "vq_ring_sync_caps": (_P,),
    "vq_ring_alloc": (_L, _P),
    "vq_ring_free": (_P,),
    "vq_ring_export": (_P, _P),
    "vq_ring_open": (_P, _P),
    "vq_ring_close": (_P,),
    "vq_ring_step": (_P, _U, _P, _U, _I, _P, _P, _L, _I, _I, _L, _I, _P, _U,
                     _P),
    "vq_ring_hop_f32": (_P, _P, _I, _L, _I, _P),
    "vq_ring_copy_f32": (_P, _P, _L, _P),
    # long long* out: CUDA kernels the argmin engine's entries (assign,
    # delta, blocked) have launched in this process
    "vq_argmin_launches": (_P,),
}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` (default
    ``/usr/local/cuda``); raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are built from kernels/csrc at first use")


def source_hash() -> str:
    """Hash of every csrc file and the flags: the build directory's key."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the library unless a build for these sources exists;
    returns its path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept in ``build.log`` beside it."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for cmd, _, proc in procs:
            text, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{log[-1]}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = [exe, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees all or none
    return lib


_library: ctypes.CDLL | None = None
_library_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argument types
    declared for every entry point.  Threads that launch at once (the
    thread runtime's workers) build and load it once."""
    global _library
    if _library is None:
        with _library_lock:
            if _library is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _library = lib
    return _library


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def current_stream(dev: torch.device) -> int:
    """The raw handle of ``dev``'s current CUDA stream, the one every
    wrapper's launch takes: ``torch.cuda.current_stream(dev).cuda_stream``
    without its Python layers, a few microseconds of every launch's host
    time."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def on_device(dev: torch.device):
    """``torch.cuda.device(dev)`` around a launch, or nothing where ``dev``
    is the current device already (the runtime launches there)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
