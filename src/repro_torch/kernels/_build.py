"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ``ctypes``.

Every ``kernels/csrc/*.cu`` is compiled for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, and linked into one shared
library with a plain C interface.  The library goes into
``kernels/.build/<hash of the sources and flags>/``, a directory that
``.gitignore`` lists, so an edited source gets a fresh build and an
unchanged one is loaded as it is.  Nothing is built at import: the first
kernel launch builds, and a machine without ``nvcc`` gets an error there.

Each C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launches; ``check`` raises when
that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / ".build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argument types (every entry point returns int)
SIGNATURES = {
    # zwin, w0, eps, wout, M, tau, K, D, stream
    "vq_window_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # z, w, counts, zsum, mind, assign, w2, pmin, pidx, M, B, K, D, kchunk,
    # stream
    "vq_delta_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _P),
    # z, w, mind, assign, w2, pmin, pidx, M, B, K, D, kchunk, stream
    "vq_assign_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # full, vals, idx, residual, M, N, k, stream
    "vq_topk_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
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


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argument types
    declared for every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
