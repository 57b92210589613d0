"""Build the port's CUDA sources into a shared library and load it.

Route: ``nvcc`` by hand into a library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The library lands in ``build/torch_kernels/`` at the repository root,
named by a hash of the source and flags, so a changed source builds
anew and an unchanged one is loaded as it is (the hash covers the
headers in ``csrc/`` too).  A source's macros
(``-DNAME=VALUE``) come from the module that binds it, so that numbers
the kernel and its wrapper share live in one place.  Nothing here runs
at import time: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

#: a source's macro definitions, ``((NAME, value), ...)``
Defines = Tuple[Tuple[str, int], ...]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: what the last build of each source reported: seconds, and the
#: ptxas lines (registers, spills) of ``-Xptxas -v``
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's conventional install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels are built on the machine with "
                       "the card)")


def flags(defines: Defines = ()) -> Tuple[str, ...]:
    """nvcc's flags for a source built with ``defines``."""
    return NVCC_FLAGS + tuple(f"-D{name}={value}" for name, value in defines)


def _digest(source: str, defines: Defines) -> str:
    """A hash of the source, the headers beside it and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags(defines)).encode())
    return h.hexdigest()[:16]


def library_path(source: str, defines: Defines = ()) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR,
                        f"lib{stem}_{_digest(source, defines)}.so")


def _start(source: str, defines: Defines):
    out = library_path(source, defines)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *flags(defines), "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(sources: Dict[str, Defines], force: bool = False) -> dict:
    """Build every source of ``{source: defines}`` that has no library
    yet (or all of them with ``force``), one ``nvcc`` per source, all
    started together.  Returns ``{source: {"path", "seconds",
    "ptxas"}}``; raises on a failed build with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    t0 = time.perf_counter()
    for src, defines in sources.items():
        if force or not os.path.exists(library_path(src, defines)):
            started[src] = _start(src, defines)
    for src, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        BUILD_INFO[src] = {
            "path": out, "seconds": time.perf_counter() - t0,
            "ptxas": [ln for ln in log.splitlines()
                      if "ptxas" in ln or "spill" in ln]}
    for src, defines in sources.items():
        BUILD_INFO.setdefault(src, {"path": library_path(src, defines),
                                    "seconds": 0.0, "ptxas": []})
    return {src: BUILD_INFO[src] for src in sources}


def load(source: str, defines: Defines = ()) -> ctypes.CDLL:
    """The loaded library for ``source`` built with ``defines``,
    building it on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build({source: defines})
            lib = ctypes.CDLL(library_path(source, defines))
            _libs[source] = lib
        return lib
