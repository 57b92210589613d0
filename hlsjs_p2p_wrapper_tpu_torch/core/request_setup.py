# A copy of the reference's core/request_setup.py
# (hlsjs_p2p_wrapper_tpu/core/request_setup.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""Sandboxed harvesting of user request-setup callbacks.

The reference lets apps customize requests through hls.js's
``xhrSetup(xhr, url)`` hook, and harvests headers/credentials by
running the callback against a locked-down XHR mock
(lib/utils.js:27-48 using ``BaseXHR`` from xhr-shaper).  The rebuild's
analogue: run the callback against a :class:`RequestStub` that permits
only ``set_request_header`` / ``setRequestHeader`` and the
``with_credentials`` flag; anything else raises
:class:`SetupSandboxError` — same containment contract as the
reference's "forbidden property" throw (lib/utils.js:43-45,
test/xhr-setup.js:5-21).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from .errors import SetupSandboxError


class RequestStub:
    """Mock request object handed to the user's setup callback."""

    def __init__(self, headers: Dict[str, str]):
        object.__setattr__(self, "_headers", headers)
        object.__setattr__(self, "_with_credentials", False)

    def set_request_header(self, header: str, value: str) -> None:
        self._headers[header] = value

    # JS-style alias so hls.js-shaped callbacks port over unchanged
    setRequestHeader = set_request_header

    @property
    def with_credentials(self) -> bool:
        return self._with_credentials

    @with_credentials.setter
    def with_credentials(self, on: bool) -> None:
        object.__setattr__(self, "_with_credentials", bool(on))

    # camelCase alias
    withCredentials = with_credentials

    def __getattr__(self, name: str):
        raise AttributeError(f"forbidden access to '{name}' on request stub")

    def __setattr__(self, name: str, value) -> None:
        if name in ("with_credentials", "withCredentials"):
            object.__setattr__(self, "_with_credentials", bool(value))
            return
        # Event-handler installation is explicitly forbidden, like the
        # reference's note about `on...` handlers (lib/utils.js:41)
        raise AttributeError(f"forbidden assignment to '{name}' on request stub")


def extract_info_from_request_setup(
        setup: Optional[Callable], url: str,
        headers_base: Optional[Dict[str, str]] = None,
) -> Tuple[Dict[str, str], bool]:
    """Run ``setup(request_stub, url)`` in the sandbox; return
    ``(headers, with_credentials)``.  Headers dict is at least empty
    (lib/utils.js:28,47)."""
    headers: Dict[str, str] = dict(headers_base) if headers_base else {}
    stub = RequestStub(headers)
    try:
        if setup:
            setup(stub, url)
    except Exception as e:  # noqa: BLE001 — sandbox containment boundary
        raise SetupSandboxError(
            "request setup callback is trying to access a forbidden "
            f"property/method of the request stub. Internal mock error: {e}"
        ) from e
    return headers, stub.with_credentials
