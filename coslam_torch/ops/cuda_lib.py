"""Build and load the package's CUDA kernels (``coslam_torch/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into its own shared library under ``build/<hash>/``
at the repository root, keyed by a hash of the sources and flags; the
libraries are loaded with ``ctypes``. The build runs at first use (or
ahead of time through ``build_all``), one ``nvcc`` per source, all started
together. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each kernel library: argtypes (every pointer, host array
# of pointers and the stream as c_void_p: ctypes would otherwise pass them
# as 32-bit ints)
SIGNATURES = {
    # build_pyramid(img, dx, dy, sm[], C, H, W, n_levels, stream)
    "build_pyramid": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # klt_track(prev[], cur[], levels[], n_levels, pos, valid, pos_out,
    #           valid_out, ssd_out, gain_out, C, N, H, W, radius, n_iter,
    #           with_gain, lam, conv, border, ssd_thr, stream)
    "klt_track": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                  _I, _I, _I, _F, _F, _F, _F, _P],
    # extract_windows(imgs, base, out, C, H, W, N, G, stream)
    "extract_windows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # ncc_blocks(imgs, pos, blocks, ok, C, H, W, N, radius, xmax, ymax,
    #            stream)
    "ncc_blocks": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    # ncc_search(img, centers, templates, best_px, best_score, H, W, N,
    #            patch_radius, search_radius, stream)
    "ncc_search": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in coslam_torch/csrc")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SIGNATURES):
        h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every kernel library that is not built yet, in parallel.
    Returns {name: {"seconds": wall time of this build (0 if cached),
    "ptxas": the -Xptxas -v report}}. Raises if a compile fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SIGNATURES:
        if (out_dir / f"lib{name}.so").exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        log = open(out_dir / f"{name}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), tmp, log)
    info = {}
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    seconds = time.perf_counter() - t0
    for name in SIGNATURES:
        log = out_dir / f"{name}.log"
        info[name] = {"seconds": seconds if name in procs else 0.0,
                      "ptxas": log.read_text() if log.exists() else ""}
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{info[n]['ptxas']}" for n in failed))
    return info


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def pointer_array(ptrs):
    """A host array of device pointers (ints) for a ``T* const*``
    parameter; the kernel's host code reads it before the call returns."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def int_array(vals):
    """A host array of ints for a ``const int*`` parameter."""
    return (ctypes.c_int * len(vals))(*vals)


def check(name: str, rc: int) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if rc != 0:
        import torch
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{rc} ({torch.cuda.get_device_name()})")
