# A copy of the reference's engine/cdn.py
# (hlsjs_p2p_wrapper_tpu/engine/cdn.py): the same names, formats and bytes;
# the imports point at the port's own modules.
"""CDN (origin) transport.

The reference's agent "ultimately fails-through to XHRs always"
(lib/integration/p2p-loader-generator.js:103-104); this module is the
rebuild's origin-fetch path: a small transport protocol with a real
threaded HTTP implementation for deployments and deterministic fakes
in ``testing/mock_cdn.py`` for everything else.

Callbacks contract (all HTTP-shaped, mirroring §2.10 of SURVEY.md):
  on_progress({"cdn_downloaded": int})      cumulative bytes
  on_success(bytes)                         full payload
  on_error({"status": int})                 terminal HTTP failure
"""

from __future__ import annotations

import threading
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional, Protocol


class FetchHandle(Protocol):
    def abort(self) -> None: ...


class CdnTransport(Protocol):
    """Origin fetch: one call per segment request."""

    def fetch(self, req_info: Dict, callbacks: Dict[str, Callable]) -> FetchHandle:
        ...


class _ThreadHandle:
    def __init__(self):
        self.aborted = threading.Event()

    def abort(self) -> None:
        self.aborted.set()


class HttpCdnTransport:
    """Blocking-read HTTP fetch on a daemon thread with chunked
    progress reporting.  ``req_info`` carries ``url``, ``headers``, and
    ``with_credentials`` (credentials are a browser concept; honored
    here by simply passing headers through)."""

    CHUNK_SIZE = 64 * 1024

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s

    def fetch(self, req_info: Dict, callbacks: Dict[str, Callable]) -> _ThreadHandle:
        handle = _ThreadHandle()

        def run() -> None:
            url = req_info["url"]
            headers = dict(req_info.get("headers") or {})
            request = urllib.request.Request(url, headers=headers)
            data = bytearray()
            try:
                with urllib.request.urlopen(request, timeout=self.timeout_s) as resp:
                    while not handle.aborted.is_set():
                        chunk = resp.read(self.CHUNK_SIZE)
                        if not chunk:
                            break
                        data.extend(chunk)
                        callbacks["on_progress"]({"cdn_downloaded": len(data)})
                if handle.aborted.is_set():
                    return
                callbacks["on_success"](bytes(data))
            except urllib.error.HTTPError as e:
                if not handle.aborted.is_set():
                    callbacks["on_error"]({"status": e.code})
            except Exception:  # fault-ok: surfaced to the caller as an HTTP-shaped status-0 error
                if not handle.aborted.is_set():
                    callbacks["on_error"]({"status": 0})

        threading.Thread(target=run, daemon=True).start()
        return handle


def slice_for_range(payload: bytes, headers: Optional[Dict]) -> bytes:
    """Apply an HTTP ``Range: bytes=a-b`` header (inclusive end, the
    on-wire convention the loader produces) to a payload."""
    range_value = (headers or {}).get("Range")
    if not range_value:
        return payload
    spec = range_value.split("=", 1)[1]
    start_s, end_s = spec.split("-", 1)
    start = int(start_s) if start_s else 0
    end = int(end_s) + 1 if end_s else len(payload)
    return payload[start:end]
