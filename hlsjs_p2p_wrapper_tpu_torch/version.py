# A copy of the reference's version.py (hlsjs_p2p_wrapper_tpu/version.py):
# the same names, formats and bytes; the imports point at the port's own
# modules.
"""Version define for the framework.

The reference injects ``_VERSION_`` at build time via uglifyify
``global_defs`` (reference: Gruntfile.js:23-31,
lib/hlsjs-p2p-wrapper-private.js:237-239).  Here the single source of
truth is this module; an environment override mimics the build-time
define so the api test can exercise both paths the way
``test/api.js:5-11`` does.
"""

import os

__version__ = "0.5.0"


def get_version() -> str:
    """Return the framework version (env override first, like the
    build-time ``_VERSION_`` global define)."""
    return os.environ.get("P2P_WRAPPER_VERSION", __version__)
