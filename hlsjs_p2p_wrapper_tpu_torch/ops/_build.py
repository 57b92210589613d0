"""Build the port's CUDA sources into a shared library and load it.

Route: ``nvcc`` by hand into a library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The library lands in ``build/torch_kernels/`` at the repository root,
named by a hash of the sources and flags, so a changed source builds
anew and an unchanged one is loaded as it is.  Nothing here runs at
import time: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

#: one library per source; each entry is built by its own nvcc
SOURCES = ("swarm_step.cu",)

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


def _digest(source: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, source), "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{_digest(source)}.so")


def _start(source: str):
    out = library_path(source)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(sources: Optional[List[str]] = None, force: bool = False) -> dict:
    """Build every source that has no library yet (or all of them with
    ``force``), one ``nvcc`` per source, all started together.  Returns
    ``{source: {"path", "seconds", "ptxas"}}``; raises on a failed
    build with the compiler's output."""
    sources = list(sources or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    t0 = time.perf_counter()
    for src in sources:
        if force or not os.path.exists(library_path(src)):
            started[src] = _start(src)
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
    for src in sources:
        BUILD_INFO.setdefault(src, {"path": library_path(src),
                                    "seconds": 0.0, "ptxas": []})
    return {src: BUILD_INFO[src] for src in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, building it on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(library_path(source))
            _libs[source] = lib
        return lib
