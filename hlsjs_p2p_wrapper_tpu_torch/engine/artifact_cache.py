"""Warm starts for the port's sweeps: the crash-safe journal, the
content-addressed row cache, and a count of kernel builds and graph
captures.  The reference's ``engine/artifact_cache.py``, copied where
it is JAX-free and rebuilt where it is not.

**Copied, with the same names and on-disk formats** (``:261-263``,
``:318-565``): :func:`atomic_write_bytes` / ``_text`` / ``_json`` and
:func:`_atomic_write`, :func:`read_jsonl_tolerant` (alias
:func:`read_jsonl_records`), :func:`_digest`, :func:`journal_path`,
:func:`journal_shards` and :class:`SweepJournal`.  For the same calls the
port's journal and the reference's are the same bytes, and each resumes
the other's file.

**The row layer** (``:716-771``): a finished sweep row, the
``(offload, rebuffer[, timeline])`` tuple, is stored full-precision
(float64 scalars and the raw timeline array, in an ``.npz``) under a
hash of the device (``("cuda", device name)`` or ``("cpu", "cpu")``:
kernel rows and plain rows agree within tolerances, not to the bit), the
toolchain (torch, its CUDA, and on the card ``nvcc``'s release line),
every ``SwarmConfig`` field, the scenario's field names, shapes and
dtypes, the bytes of every scenario tensor and of the join vector
(moved to the host in field order), ``n_steps``, ``watch_s``,
``record_every`` and a fingerprint of the sources that define a step
(:func:`code_fingerprint`: the step modules, ``ops/_build.py`` with the
kernels' ``nvcc`` flags, and every ``csrc/*.cu`` and ``csrc/*.cuh``, so
an edit to a kernel or to its flags invalidates every row).  A hit is
the dispatch's row to the bit.  The port's root is its own
(``~/.cache/hlsjs_p2p_wrapper_tpu_torch/``, or
``$HLSJS_P2P_TORCH_CACHE_DIR``): a port row and a reference row are
different numbers and never share a root.

**No twin for the executable layer.**  PyTorch has no serialized
executable, so the reference's ``enable_persistent_compilation_cache``,
``executable_key``, ``batch_runner``, ``_load_executable`` and
``_store_executable`` (``:112-131``, ``:266-283``, ``:627-712``) have
none here.  What takes their place:

- the kernel libraries of ``ops/_build.py``, under the reference's
  layer-1 contract (corruption can cost a build, never a wrong number or
  a crash): hashed by source, headers, flags and toolchain, checked
  against a sha256 sidecar before they are loaded, built anew when
  torn.  While a dispatch runs with a :class:`WarmStart`, each check
  (``hit`` / ``miss`` / ``corrupt``) and each library stored
  (``store``, ``nvcc``'s seconds as populate seconds) is counted under
  ``layer="executable"``;
- :class:`CompileCounter`, the reference's interface, counting the
  ``nvcc`` runs ``ops/_build.py`` starts (``builds``) and the CUDA-graph
  captures of ``swarm_kernels.capture`` (``captures``): "a warm process
  builds and captures nothing" is asserted with it.

Both layers count ``aot_cache_events{layer,result}`` and
``aot_cache_populate_seconds{layer}`` in an ``engine.telemetry``
registry.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..ops import _build
from .telemetry import MetricsRegistry

#: cache-root override
CACHE_DIR_ENV = "HLSJS_P2P_TORCH_CACHE_DIR"


def default_cache_dir() -> str:
    """``$HLSJS_P2P_TORCH_CACHE_DIR`` or
    ``~/.cache/hlsjs_p2p_wrapper_tpu_torch``."""
    return (os.environ.get(CACHE_DIR_ENV)
            or os.path.join(os.path.expanduser("~"), ".cache",
                            "hlsjs_p2p_wrapper_tpu_torch"))


# -- build and capture count ------------------------------------------

class CompileCounter:
    """Counts, while attached, the ``nvcc`` runs ``ops/_build.py``
    starts (``builds``) and the CUDA-graph captures of
    ``swarm_kernels.capture`` (``captures``); ``compiles`` is the two
    together.  A library loaded from disk and a graph replayed count
    nothing.

    Use as a context manager (``with CompileCounter() as probe:``) or
    attach for a process lifetime (``CompileCounter().attach()``, before
    anything touches the kernels)."""

    def __init__(self):
        self.builds = 0
        self.captures = 0
        self._lock = threading.Lock()

    def record(self, event: str, _seconds: float = 0.0) -> None:
        with self._lock:
            if event == "build":
                self.builds += 1
            elif event == "capture":
                self.captures += 1

    @property
    def compiles(self) -> int:
        with self._lock:
            return self.builds + self.captures

    def attach(self) -> "CompileCounter":
        _build.listen(self)
        return self

    def detach(self) -> None:
        _build.unlisten(self)

    def __enter__(self) -> "CompileCounter":
        return self.attach()

    def __exit__(self, *exc) -> None:
        self.detach()


# -- key material ------------------------------------------------------

#: modules whose source defines a step and the row numerics, beside
#: every ``csrc/*.cu`` and ``csrc/*.cuh``; ``ops/_build.py`` holds the
#: kernels' ``nvcc`` flags, which change their float bits
_FINGERPRINT_MODULES = ("ops/swarm_sim.py", "ops/swarm_kernels.py",
                        "ops/ewma.py", "core/abr.py", "ops/_build.py")

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CODE_FINGERPRINT = None


def _fingerprint_files(package_root: str) -> list:
    csrc = os.path.join(package_root, "csrc")
    kernels = sorted(os.path.join("csrc", name) for name in os.listdir(csrc)
                     if name.endswith((".cu", ".cuh")))
    return list(_FINGERPRINT_MODULES) + kernels


def _fingerprint(package_root: str) -> str:
    """sha256 over the step-defining sources of the package at
    ``package_root``."""
    h = hashlib.sha256()
    for rel in _fingerprint_files(package_root):
        with open(os.path.join(package_root, rel), "rb") as fh:
            h.update(rel.encode())
            h.update(fh.read())
    return h.hexdigest()


def code_fingerprint() -> str:
    """:func:`_fingerprint` of this package (memoized)."""
    global _CODE_FINGERPRINT
    if _CODE_FINGERPRINT is None:
        _CODE_FINGERPRINT = _fingerprint(_PACKAGE_ROOT)
    return _CODE_FINGERPRINT


def device_signature(device) -> tuple:
    """``("cuda", the card's name)`` or ``("cpu", "cpu")``."""
    device = torch.device(device)
    if device.type == "cuda":
        return ("cuda", torch.cuda.get_device_name(device))
    return (device.type, device.type)


def toolchain_versions(device) -> dict:
    """torch, its CUDA, and on the card ``nvcc``'s release line."""
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": (_build.toolchain()
                     if torch.device(device).type == "cuda" else None)}


def _tree_signature(scenario) -> list:
    """Field names, shapes and dtypes of a scenario ``NamedTuple``."""
    return [[name, list(t.shape), str(t.dtype)]
            for name, t in scenario._asdict().items()]


def _config_signature(config) -> dict:
    """Every ``SwarmConfig`` field, by name."""
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in config._asdict().items()}


def _digest(material) -> str:
    return hashlib.sha256(
        json.dumps(material, sort_keys=True).encode()).hexdigest()


def _tensor_digest(t) -> bytes:
    """sha256 of one tensor's raw bytes, moved to the host."""
    return hashlib.sha256(
        np.ascontiguousarray(t.detach().cpu().numpy())).digest()


def _leaf_bytes(tensors) -> bytes:
    """sha256 over the sha256 of each of ``tensors``' raw bytes, in
    order.  The copies and hashes run on a few threads (both release the
    interpreter lock): a point of the 1,048,576-peer grid is ~40 MB."""
    tensors = list(tensors)
    with ThreadPoolExecutor(max_workers=min(8, len(tensors))) as pool:
        digests = list(pool.map(_tensor_digest, tensors))
    return hashlib.sha256(b"".join(digests)).digest()


def row_key(config, scenario, join, n_steps: int, *, watch_s: float,
            record_every: int) -> str:
    """The row cache's key: the device, the toolchain, the config, the
    scenario's signature and bytes, the join vector, the run's extent
    and the code fingerprint."""
    device = scenario.join_s.device
    platform, device_kind = device_signature(device)
    return _digest({
        "kind": "sweep-row",
        "platform": platform,
        "device_kind": device_kind,
        "versions": toolchain_versions(device),
        "config": _config_signature(config),
        "scenario_tree": _tree_signature(scenario),
        "scenario_bytes": _leaf_bytes(scenario).hex(),
        "join_bytes": _leaf_bytes(
            [torch.as_tensor(join, dtype=torch.float32)]).hex(),
        "n_steps": n_steps,
        "watch_s": watch_s,
        "record_every": record_every,
        "code": code_fingerprint(),
    })


def atomic_write_bytes(path: str, data: bytes, *,
                       durable: bool = True) -> None:
    """Crash-safe file write: temp file in the target directory,
    ``fsync``, then ``os.replace``.  A reader, or a crash at any point,
    sees either the complete old content or the complete new content.

    ``durable=False`` skips the fsync (the rename is still atomic): for
    the cache bodies, whose readers detect a torn file and degrade to a
    counted recompute.  User-facing artifacts and the journal keep the
    default."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            if durable:
                # the rename is only durable if the data is on disk
                # first: replace-before-flush can surface as an empty
                # file after a power cut
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # fault-ok: best-effort temp cleanup on the re-raise path
        raise


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj, *, indent: Optional[int] = 1
                      ) -> None:
    atomic_write_text(path, json.dumps(obj, indent=indent) + "\n")


def _atomic_write(path: str, data: bytes) -> None:
    """Cache-body write: atomic rename, no fsync (a torn body reads as
    ``corrupt`` and recomputes)."""
    atomic_write_bytes(path, data, durable=False)


def read_jsonl_tolerant(path: str):
    """Stream the parseable records of an append-only JSON-lines file,
    skipping blank lines and unparsable fragments: every whole line was
    flushed before its writer moved on, so a skipped fragment is at most
    the record a crash interrupted."""
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue


#: the reference's older name, kept as an alias
read_jsonl_records = read_jsonl_tolerant


# -- the crash-safe sweep journal --------------------------------------

def journal_path(cache_dir: str, meta: dict,
                 host_id: Optional[str] = None) -> str:
    """Journal location for one sweep identity, content-addressed by
    the sweep's meta under ``journals/`` of the cache root:
    ``journals/<digest>.jsonl``, or with a ``host_id`` that host's own
    shard ``journals/<digest>/<host_id>.jsonl`` (readers merge the
    shards: :func:`journal_shards`, ``SweepJournal(merge=...)``)."""
    digest = _digest({"kind": "sweep-journal", **meta})
    if host_id is None:
        return os.path.join(cache_dir, "journals", digest + ".jsonl")
    return os.path.join(cache_dir, "journals", digest,
                        f"{host_id}.jsonl")


def journal_shards(cache_dir: str, meta: dict) -> list:
    """Every existing journal file of one sweep identity: the
    single-host file first, then the per-host shards sorted by host
    id."""
    digest = _digest({"kind": "sweep-journal", **meta})
    paths = []
    legacy = os.path.join(cache_dir, "journals", digest + ".jsonl")
    if os.path.exists(legacy):
        paths.append(legacy)
    shard_dir = os.path.join(cache_dir, "journals", digest)
    if os.path.isdir(shard_dir):
        paths.extend(os.path.join(shard_dir, name)
                     for name in sorted(os.listdir(shard_dir))
                     if name.endswith(".jsonl"))
    return paths


class SweepJournal:
    """Crash-safe sweep progress: one JSON line per completed row,
    appended, flushed and fsync'd a drained chunk at a time, so a
    SIGKILLed sweep knows what it finished.

    The journal records row-cache keys, not values: a resumed run
    replays it against the row cache, which serves the completed rows'
    values, and dispatches only the rest (a journaled key missing from
    the cache recomputes).

    Lines: one ``meta`` header (the sweep identity's digest;
    ``resume=True`` refuses a journal whose digest differs), ``row``
    per completed row, and a final ``done`` written by :meth:`finalize`
    after the artifact is in place.  Reading tolerates a torn last line.

    ``merge`` names other journal files of the same sweep identity
    (per-host shards) whose rows are folded into ``completed`` read-only;
    a shard with another digest is refused like a mismatched resume."""

    def __init__(self, path: str, meta: dict, *, resume: bool = False,
                 merge=()):
        self.path = path
        self.digest = _digest({"kind": "sweep-journal", **meta})
        self.completed: set = set()
        self.finished = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        for other in merge:
            if os.path.abspath(other) == os.path.abspath(path):
                continue  # own shard is read by the resume path below
            for record in self._read(other):
                kind = record.get("kind")
                if kind == "meta":
                    if record.get("digest") != self.digest:
                        raise ValueError(
                            f"journal shard {other} was written by a "
                            f"different sweep configuration — not "
                            f"merging it")
                elif kind == "row":
                    self.completed.add(record["key"])
        if resume and os.path.exists(path):
            for record in self._read():
                kind = record.get("kind")
                if kind == "meta":
                    if record.get("digest") != self.digest:
                        raise ValueError(
                            f"journal {path} was written by a "
                            f"different sweep configuration — not "
                            f"resuming against it")
                elif kind == "row":
                    self.completed.add(record["key"])
                elif kind == "done":
                    self.finished = True
            self._fh = open(path, "a", encoding="utf-8")
            with open(path, "rb") as raw:
                raw.seek(0, os.SEEK_END)
                size = raw.tell()
                torn = False
                if size:
                    raw.seek(size - 1)
                    torn = raw.read(1) != b"\n"
            if torn:
                # start appends on a fresh line, or the first new record
                # would join the torn fragment and both would be lost
                self._fh.write("\n")
                self._fh.flush()
        else:
            self._fh = open(path, "w", encoding="utf-8")
            self._append({"kind": "meta", "digest": self.digest})

    def _read(self, path: Optional[str] = None):
        yield from read_jsonl_records(path or self.path)

    def _append(self, *records: dict) -> None:
        self._fh.write("".join(json.dumps(record) + "\n"
                               for record in records))
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def record_row(self, key: str) -> None:
        """One completed row (its row-cache key), durable before the
        engine moves on."""
        self.record_rows([key])

    def record_rows(self, keys) -> None:
        """A batch of completed rows under one flush and fsync: the
        dispatch journals a drained chunk at once."""
        fresh = [key for key in keys if key not in self.completed]
        if not fresh:
            return
        self.completed.update(fresh)
        self._append(*({"kind": "row", "key": key} for key in fresh))

    def finalize(self) -> None:
        """Mark the sweep complete: call after the artifact write
        succeeded, and only when no rows failed (a partial run stays
        resumable)."""
        if not self.finished:
            self._append({"kind": "done"})
            self.finished = True

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "SweepJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class WarmStart:
    """The warm-start engine the chunked dispatch threads through
    (``ops/dispatch.py``, ``warm_start=``): the row cache, and the
    kernel libraries' events under ``layer="executable"``.

    ``row_cache=False`` stores and serves no row.  ``aot_cache=False``
    leaves the libraries' events out of this engine's counts (the
    libraries are cached by ``ops/_build.py`` in any case).
    ``registry`` receives the ``aot_cache_events`` and
    ``aot_cache_populate_seconds`` families, and the dispatch's
    prefilter seconds (``aot_cache_prefilter_seconds``)."""

    def __init__(self, cache_dir: Optional[str] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 row_cache: bool = True, aot_cache: bool = True):
        self.cache_dir = cache_dir or default_cache_dir()
        # a newly created cache root is owner-only; a pre-existing
        # directory's modes are the operator's
        if not os.path.isdir(self.cache_dir):
            os.makedirs(self.cache_dir, mode=0o700, exist_ok=True)
            try:
                os.chmod(self.cache_dir, 0o700)
            except OSError:
                pass
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.rows_enabled = row_cache
        self.aot_enabled = aot_cache

    # -- events --------------------------------------------------------

    def _event(self, layer: str, result: str) -> None:
        self.registry.counter("aot_cache_events", layer=layer,
                              result=result).inc()

    def _populate(self, layer: str, seconds: float) -> None:
        self.registry.counter("aot_cache_populate_seconds",
                              layer=layer).inc(seconds)

    def event_counts(self, layer: str) -> dict:
        """``{result: count}`` for one layer."""
        return {labels["result"]: value
                for labels, value in
                self.registry.series("aot_cache_events")
                if labels.get("layer") == layer}

    def populate_seconds(self) -> float:
        return float(sum(
            value for _labels, value in
            self.registry.series("aot_cache_populate_seconds")))

    # -- the kernel libraries ------------------------------------------

    def record(self, event: str, seconds: float = 0.0) -> None:
        """A kernel library's event (``ops/_build.py``'s listeners): a
        check's ``hit`` / ``miss`` / ``corrupt``, or a ``store`` with
        ``nvcc``'s seconds."""
        if event in ("hit", "miss", "corrupt", "store"):
            self._event("executable", event)
        if event == "store":
            self._populate("executable", seconds)

    # -- the dispatch's prefilter --------------------------------------

    def note_prefilter(self, seconds: float) -> None:
        """Seconds the dispatch spent building, keying and loading
        items before its first dispatch."""
        self.registry.counter("aot_cache_prefilter_seconds").inc(seconds)

    def prefilter_seconds(self) -> float:
        return float(sum(
            value for _labels, value in
            self.registry.series("aot_cache_prefilter_seconds")))

    # -- rows ------------------------------------------------------------

    def _row_path(self, key: str) -> str:
        return os.path.join(self.cache_dir, "rows", key + ".npz")

    def row_key(self, config, scenario, join, n_steps: int, *,
                watch_s: float, record_every: int) -> str:
        return row_key(config, scenario, join, n_steps,
                       watch_s=watch_s, record_every=record_every)

    def row_load(self, key: str):
        """The cached ``(offload, rebuffer[, timeline])`` tuple, or None;
        bit-identical to the dispatch's row it replaces."""
        if not self.rows_enabled:
            return None
        try:
            with np.load(self._row_path(key)) as data:
                offload = float(data["offload"])
                rebuffer = float(data["rebuffer"])
                timeline = (np.array(data["timeline"])
                            if "timeline" in data else None)
        except OSError:
            self._event("row", "miss")
            return None
        except Exception:  # noqa: BLE001 — a truncated or flipped npz
            self._event("row", "corrupt")
            return None
        self._event("row", "hit")
        if timeline is not None:
            return (offload, rebuffer, timeline)
        return (offload, rebuffer)

    def row_store(self, key: str, metric) -> None:
        if not self.rows_enabled:
            return
        try:
            start = time.perf_counter()
            arrays = {"offload": np.float64(metric[0]),
                      "rebuffer": np.float64(metric[1])}
            if len(metric) > 2:
                arrays["timeline"] = np.asarray(metric[2])
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            _atomic_write(self._row_path(key), buf.getvalue())
            self._populate("row", time.perf_counter() - start)
            self._event("row", "store")
        except Exception:  # noqa: BLE001 — a failed store must never
            # fail the sweep; the row is an optimization
            self._event("row", "store_error")

    def summary(self) -> dict:
        """Per-layer event counts and populate seconds."""
        return {"cache_dir": self.cache_dir,
                "executable": self.event_counts("executable"),
                "row": self.event_counts("row"),
                "populate_s": round(self.populate_seconds(), 3)}
