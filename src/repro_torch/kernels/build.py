"""Build the package's CUDA sources into shared libraries at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with :mod:`ctypes`. Libraries go to
``build/torch_ext/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source, the shared headers and the flags, so an
edited source or header rebuilds and an unchanged one is reused. A library
is written under a temporary name and renamed into place, so concurrent
builders never load a partial file.

Nothing here runs at import time: the wrappers call :func:`load` when they
first launch a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = {
    "adv_gather": _HERE / "adv_gather" / "adv_gather.cu",
    "predicate_scan": _HERE / "predicate_scan" / "predicate_scan.cu",
    "hist": _HERE / "hist" / "hist.cu",
    "onehot_wide": _HERE / "onehot_wide" / "onehot_wide.cu",
    "bitunpack": _HERE / "bitunpack" / "bitunpack.cu",
    "flash": _HERE / "flash" / "flash.cu",
}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; a shared library is process-global anyway
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> compiler output of the build this process ran (ptxas register use)
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers the
    sources share (``kernels/*.cuh``) and the flags."""
    text = SOURCES[name].read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_HERE.glob("*.cuh")))
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile every named source (all by default) whose library is
    missing: one ``nvcc`` per source, all started together. Returns the
    seconds each compile took (empty when everything was built already)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    seconds = {}
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = log
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if needed.

    ``signatures`` maps each exported function to ``(argtypes, restype)``;
    they are set once, when the library is first loaded.
    """
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib
