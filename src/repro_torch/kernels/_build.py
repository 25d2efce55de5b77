"""Build and load the port's CUDA kernels.

The sources under ``kernels/csrc/`` have a plain C interface. At first use
each is compiled by ``nvcc`` for ``sm_90a`` (one process per source, all
started together), the objects are linked into one shared library under
``build/kernels/`` at the root of the checkout, and the library is loaded
with ``ctypes``. The library's file name carries a hash of the sources and
the headers they include, so an edited file is rebuilt and a stale library
is never loaded.

Nothing here runs when the module is imported: machines without a CUDA
toolchain (the CPU tests' included) import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES: Tuple[str, ...] = ("gmm.cu", "flash.cu", "flash_qpos.cu")
HEADERS: Tuple[str, ...] = ("hopper.cuh",)      # included by the sources
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported function: (argtypes, restype). Each returns
# the launch's cudaGetLastError() as an int.
SIGNATURES: Dict[str, Tuple[tuple, type]] = {
    # x, w, block_expert, y, M, K, N, bm, E, block_m, block_n, run, trans_w, stream
    "repro_gmm_bf16": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P), _I),
    # q, k, v, q_offset, q_pos, kv_pos, out, acc, m, l, ws, counters, B, H, Hkv, Sq,
    # Skv, hd, kv_offset, causal, window, scale, path, splits, stream
    "repro_flash_fwd_bf16": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P), _I),
    # hd, *blocks: blocks of the flash "stream" kernel an SM holds
    "repro_flash_stream_blocks": ((_I, ctypes.POINTER(_I)), _I),
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""   # compiler output (ptxas register/spill report) of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the port's CUDA kernels are built from source at first use")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_kernels-{h.hexdigest()[:16]}.so"


def build(out: Optional[Path] = None) -> Path:
    """Compile every source in parallel and link the shared library."""
    global build_log
    out = out or library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = out.parent / f"{Path(name).stem}-{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, _, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {name} ==\n{text}")
        if p.returncode:
            failed.append(name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _ in procs]],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources if needed."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
