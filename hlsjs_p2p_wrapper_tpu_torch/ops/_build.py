"""Build the port's CUDA sources into a shared library and load it.

Route: ``nvcc`` by hand into a library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The library lands in ``build/torch_kernels/`` at the repository root,
named by a hash of the source, the headers in ``csrc/``, the flags and
``nvcc``'s release line, so a changed source or toolkit builds anew and
an unchanged one is loaded as it is.  A source's macros
(``-DNAME=VALUE``) come from the module that binds it, so that numbers
the kernel and its wrapper share live in one place.  Nothing here runs
at import time: the first launch builds.

The libraries are the port's analogue of the reference's serialized
executables (``engine/artifact_cache.py``), under the same contract:
corruption can cost a build, never a wrong number or a crash.  Each
library gets a sha256 sidecar (``<library>.sha256``), written after the
library's atomic rename; :func:`load` checks it before ``ctypes.CDLL``,
and a library that is torn, flipped or has no sidecar is built anew.

Listeners (:func:`listen`) are told of each check's result (``"hit"``,
``"miss"``, ``"corrupt"``), of each ``nvcc`` run started (``"build"``)
and of each library stored (``"store"``, with ``nvcc``'s seconds), and
``swarm_kernels.capture`` tells them of each CUDA-graph capture
(``"capture"``): ``engine/artifact_cache.py``'s ``WarmStart`` and
``CompileCounter`` listen.
"""

from __future__ import annotations

import ctypes
import functools
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
#: sources whose device code ``nvcc`` splits into parallel jobs, one a
#: core (``--split-compile 0``): the step source's ~100 kernel
#: instantiations build in about half the time on an 8-core host, to the
#: same SASS for every kernel (``tools/torch_port_split_compile.py``);
#: the reduction source's few kernels build without
SPLIT_SOURCES = ("swarm_step.cu",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: what the last build of each source reported: seconds, and the
#: ptxas lines (registers, spills) of ``-Xptxas -v``
BUILD_INFO: Dict[str, dict] = {}
#: objects with a ``record(event, seconds)`` method, told of the events
#: named in the module docstring
_listeners: set = set()
_listen_lock = threading.Lock()


def listen(listener) -> None:
    with _listen_lock:
        _listeners.add(listener)


def unlisten(listener) -> None:
    with _listen_lock:
        _listeners.discard(listener)


def emit(event: str, seconds: float = 0.0) -> None:
    """Tell every listener of ``event``."""
    with _listen_lock:
        listeners = list(_listeners)
    for listener in listeners:
        listener.record(event, seconds)


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


@functools.lru_cache(maxsize=None)
def toolchain() -> str:
    """``nvcc --version``'s release line, or ``""`` where no ``nvcc``
    runs (a machine without the toolkit builds nothing)."""
    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=120).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return ""
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[-1] if lines else out.strip()


def flags(defines: Defines = (), source: str = "") -> Tuple[str, ...]:
    """nvcc's flags for ``source`` built with ``defines``."""
    split = ("--split-compile", "0") if source in SPLIT_SOURCES else ()
    return (NVCC_FLAGS + split
            + tuple(f"-D{name}={value}" for name, value in defines))


def _digest(source: str, defines: Defines) -> str:
    """A hash of the source, the headers beside it, the flags and the
    toolchain."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags(defines, source)).encode())
    h.update(toolchain().encode())
    return h.hexdigest()[:16]


def library_path(source: str, defines: Defines = ()) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR,
                        f"lib{stem}_{_digest(source, defines)}.so")


def _sidecar(path: str) -> str:
    return path + ".sha256"


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def check(path: str) -> str:
    """``"hit"`` when the library at ``path`` and its sidecar agree,
    ``"miss"`` when there is no library, ``"corrupt"`` otherwise (a
    torn or flipped library, or one without its sidecar)."""
    if not os.path.exists(path):
        return "miss"
    try:
        with open(_sidecar(path), encoding="ascii") as fh:
            want = fh.read().strip()
        return "hit" if want == _file_sha256(path) else "corrupt"
    except OSError:
        return "corrupt"


def _store(path: str) -> None:
    """Write ``path``'s sidecar, atomically, after its library's
    rename."""
    tmp = f"{_sidecar(path)}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="ascii") as fh:
        fh.write(_file_sha256(path) + "\n")
    os.replace(tmp, _sidecar(path))


def _start(source: str, defines: Defines):
    out = library_path(source, defines)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *flags(defines, source), "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(sources: Dict[str, Defines], force: bool = False) -> dict:
    """Build every source of ``{source: defines}`` that has no intact
    library (:func:`check`; all of them with ``force``), one ``nvcc``
    per source, all started together.  Returns ``{source: {"path", "seconds",
    "ptxas"}}``; raises on a failed build with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    t0 = time.perf_counter()
    for src, defines in sources.items():
        if force or check(library_path(src, defines)) != "hit":
            started[src] = _start(src, defines)
            emit("build")
    for src, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        _store(out)
        seconds = time.perf_counter() - t0
        emit("store", seconds)
        BUILD_INFO[src] = {
            "path": out, "seconds": seconds,
            "ptxas": [ln for ln in log.splitlines()
                      if "ptxas" in ln or "spill" in ln]}
    for src, defines in sources.items():
        BUILD_INFO.setdefault(src, {"path": library_path(src, defines),
                                    "seconds": 0.0, "ptxas": []})
    return {src: BUILD_INFO[src] for src in sources}


def load(source: str, defines: Defines = ()) -> ctypes.CDLL:
    """The loaded library for ``source`` built with ``defines``: on its
    first use in the process, the library on disk once its sidecar
    agrees (:func:`check`, told to the listeners), else one built
    anew."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = library_path(source, defines)
            state = check(path)
            emit(state)
            if state != "hit":
                build({source: defines}, force=True)
            lib = ctypes.CDLL(path)
            _libs[source] = lib
        return lib
