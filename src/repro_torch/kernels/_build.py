"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface under ``build/kernels/`` at the
repository root (listed in ``.gitignore``), at first use, and loaded with
``ctypes``.  Library names carry a hash of the source, of every header
in ``csrc/`` (``*.cuh``: K1 and K4's body, the int8 tile and
arithmetic of K2, K7 and the convolution) and of the flags, so an
edited source or header is rebuilt.  :func:`build` starts one ``nvcc``
per missing source, all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "BUILD_DIR", "build", "load", "build_log"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("int8_matmul", "ragged_attention", "flash_attention",
                  "paged_attention", "quantize", "residual_requant",
                  "int_conv")
# -split-compile 0: nvcc optimises a source's kernels on every core (the
# flash source's 56 instantiations build in under half the time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile", "0", "-I", str(CSRC))

# process-wide: a shared library is loaded once per process
_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (CUDA_HOME or PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    # the flags without the checkout's own path, which -I names
    h.update(" ".join(f for f in NVCC_FLAGS if f != str(CSRC)).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=KERNEL_SOURCES) -> float:
    """Compile every listed kernel source that has no library yet; one
    ``nvcc`` process per source, started together.  Returns seconds."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        _LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for ``name`` (register / shared-memory use from
    ``-Xptxas -v``) when this process built it, else ''."""
    return _LOGS.get(name, "")


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built if missing.
    ``signatures`` maps each C entry to ``(restype, argtypes)``."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib
