# A copy of the reference's core/abr.py (hlsjs_p2p_wrapper_tpu/core/abr.py):
# the same estimator, controller and contract numbers; the docstring names
# the port's batched copy, and BANDWIDTH_SAFETY is also a module name.
"""Adaptive-bitrate bandwidth estimation (player-side model).

The reference keeps hls.js's ABR honest by shaping loader stats
(lib/integration/p2p-loader-generator.js:167-204) and pins the
contract with tests against hls.js's real ``AbrController``
(test/hls-controllers.js: 128,000 B in 1 s → estimate ≈ 1,024,000 bps
± 4,000; fragLastKbps ≈ 1,024 ± 8).  Since this rebuild is
self-contained, the estimator itself is in-tree: the same
dual-EWMA design hls.js uses (duration-weighted exponential moving
averages with bias correction, min(fast, slow) readout).

The port's batched implementation with identical numerics lives in
``ops/ewma.py`` and the step kernels; both read their constants here
(module-level :data:`BANDWIDTH_SAFETY` is the controller's factor).

Timebase: milliseconds, bandwidth in bits/s — matching the reference's
numbers.
"""

from __future__ import annotations

import math
from typing import Optional

# hls.js-compatible tuning
DEFAULT_FAST_HALF_LIFE_S = 4.0
DEFAULT_SLOW_HALF_LIFE_S = 9.0
DEFAULT_ESTIMATE_BPS = 5e5
MIN_SAMPLE_DURATION_MS = 50.0


class Ewma:
    """Duration-weighted EWMA with startup bias correction: a single
    sample reads back exactly as itself."""

    def __init__(self, half_life_s: float):
        if half_life_s <= 0:
            raise ValueError("half_life must be positive")
        self.alpha = math.exp(math.log(0.5) / half_life_s)
        self.estimate = 0.0
        self.total_weight = 0.0

    def sample(self, weight: float, value: float) -> None:
        adj = self.alpha ** weight
        self.estimate = adj * self.estimate + (1.0 - adj) * value
        self.total_weight += weight

    def get_estimate(self) -> float:
        if self.total_weight == 0.0:
            return 0.0
        zero_factor = 1.0 - self.alpha ** self.total_weight
        return self.estimate / zero_factor


class EwmaBandwidthEstimator:
    """min(fast, slow) dual-EWMA bandwidth estimator in bits/s."""

    def __init__(self, fast_half_life_s: float = DEFAULT_FAST_HALF_LIFE_S,
                 slow_half_life_s: float = DEFAULT_SLOW_HALF_LIFE_S,
                 default_estimate_bps: float = DEFAULT_ESTIMATE_BPS):
        self._fast = Ewma(fast_half_life_s)
        self._slow = Ewma(slow_half_life_s)
        self._default = default_estimate_bps

    def sample(self, duration_ms: float, num_bytes: int) -> None:
        duration_ms = max(float(duration_ms), MIN_SAMPLE_DURATION_MS)
        bandwidth_bps = 8000.0 * num_bytes / duration_ms
        weight_s = duration_ms / 1000.0
        self._fast.sample(weight_s, bandwidth_bps)
        self._slow.sample(weight_s, bandwidth_bps)

    def get_estimate(self) -> float:
        if self._fast.total_weight == 0.0:
            return self._default
        return min(self._fast.get_estimate(), self._slow.get_estimate())


class AbrController:
    """Consumes fragment load stats and picks quality levels — the
    in-tree stand-in for hls.js's abr-controller, which the loader's
    stat shaping must keep honest (reference contract:
    test/hls-controllers.js:13-34)."""

    #: safety factor on the estimate when stepping up (hls.js-like)
    BANDWIDTH_SAFETY = 0.8

    def __init__(self, player=None):
        self.player = player
        self.bw_estimator = EwmaBandwidthEstimator()
        self.last_loaded_frag_level: Optional[int] = None
        self._loading_frag = None

    # Event-shaped API mirroring the reference contract surface
    def on_frag_loading(self, data) -> None:
        self._loading_frag = data["frag"] if isinstance(data, dict) else data.frag

    def on_frag_loaded(self, data) -> None:
        frag = data["frag"] if isinstance(data, dict) else data.frag
        stats = data["stats"] if isinstance(data, dict) else data.stats
        trequest = _get(stats, "trequest")
        tload = _get(stats, "tload")
        loaded = _get(stats, "loaded")
        self.bw_estimator.sample(tload - trequest, loaded)
        self.last_loaded_frag_level = _get(frag, "level")
        self._loading_frag = None

    def next_level(self, levels) -> int:
        """Highest level whose bitrate fits under the safety-scaled
        estimate; always at least level 0."""
        estimate = self.bw_estimator.get_estimate()
        best = 0
        for i, level in enumerate(levels):
            bitrate = _get(level, "bitrate", 0) or 0
            if bitrate <= estimate * self.BANDWIDTH_SAFETY:
                best = i
        return best


#: safety factor on the estimate when picking a level, for the port's
#: ops (``ops/swarm_sim.py``), which read it without the controller
BANDWIDTH_SAFETY = AbrController.BANDWIDTH_SAFETY


def compute_frag_last_kbps(stats) -> int:
    """Per-fragment delivered rate in kbit/s once the fragment is
    buffered — the reference's second contract number
    (test/hls-controllers.js:78: ≈1024 ± 8 for 128 kB over 1 s)."""
    length = _get(stats, "length", None)
    if length is None:
        length = _get(stats, "loaded")
    # clamp: a fragment delivered within one clock instant must not
    # divide by zero (hls.js yields Infinity here; a finite clamp is
    # the conscious improvement)
    elapsed_ms = max(_get(stats, "tbuffered") - _get(stats, "trequest"), 1.0)
    return round(8.0 * length / elapsed_ms)


def _get(obj, name, default=...):
    if isinstance(obj, dict):
        if default is ...:
            return obj[name]
        return obj.get(name, default)
    if default is ...:
        return getattr(obj, name)
    return getattr(obj, name, default)
