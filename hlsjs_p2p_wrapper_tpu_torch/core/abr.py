"""ABR estimator constants, copied from the reference's
``core/abr.py`` (lines 26-29 and ``AbrController.BANDWIDTH_SAFETY``
at line 85) so the port never imports the reference package.

hls.js-compatible tuning: the dual-EWMA half-lives, the estimate
before any sample, and the floor on a sample's duration.
"""

DEFAULT_FAST_HALF_LIFE_S = 4.0
DEFAULT_SLOW_HALF_LIFE_S = 9.0
DEFAULT_ESTIMATE_BPS = 5e5
MIN_SAMPLE_DURATION_MS = 50.0

#: safety factor on the estimate when picking a level
BANDWIDTH_SAFETY = 0.8
