# A copy of the reference's core/errors.py
# (hlsjs_p2p_wrapper_tpu/core/errors.py): the same names, formats and bytes;
# the imports point at the port's own modules.
"""Typed errors for the integration layer.

The reference throws bare ``Error`` with message strings; the rebuild
uses a small typed hierarchy so callers can catch by kind.
"""


class P2PWrapperError(Exception):
    """Base class for all framework errors."""


class ConfigurationError(P2PWrapperError):
    """Bad user configuration (e.g. user-supplied fragment loader —
    reference: lib/hlsjs-p2p-wrapper-private.js:150-152)."""


class SessionError(P2PWrapperError):
    """Session lifecycle violation (e.g. double start —
    reference: lib/hlsjs-p2p-wrapper-private.js:205-207)."""


class LoaderError(P2PWrapperError):
    """Fragment-loader contract violation (media-only guards —
    reference: lib/integration/p2p-loader-generator.js:53-64)."""


class MappingError(P2PWrapperError, LookupError):
    """Content-addressing failure (e.g. nonexistent track —
    reference: lib/integration/mapping/media-map.js:30-33)."""


class PlayerStateError(P2PWrapperError):
    """Player queried before required state exists (isLive before
    playlists — reference: lib/integration/player-interface.js:32-42)."""


class SetupSandboxError(P2PWrapperError):
    """User request-setup callback touched a forbidden property
    (reference: lib/utils.js:39-45)."""
