"""Batched dual-EWMA bandwidth estimation on tensors.

Port of the reference's ``ops/ewma.py``: duration-weighted dual EWMA
with bias correction and a min(fast, slow) readout, elementwise over
a ``[batch]`` of sessions.  ``_alpha`` is computed in Python double
precision and then used as float32, exactly as the reference's
weakly-typed scalar is.  ``pow`` is the one operation whose last ulp
may differ from XLA's, so EWMA fields are compared with a tolerance.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.abr import (DEFAULT_ESTIMATE_BPS, DEFAULT_FAST_HALF_LIFE_S,
                        DEFAULT_SLOW_HALF_LIFE_S, MIN_SAMPLE_DURATION_MS)
from ..core.device import resolve_device


class EwmaState(NamedTuple):
    """Per-session estimator state, each field shaped ``[batch]``."""

    fast_estimate: torch.Tensor
    fast_weight: torch.Tensor
    slow_estimate: torch.Tensor
    slow_weight: torch.Tensor


def init_state(batch: int, dtype=torch.float32, device=None) -> EwmaState:
    """Zero state on ``device`` — the card when None."""
    dev = resolve_device(device)
    return EwmaState(*(torch.zeros((batch,), dtype=dtype, device=dev)
                       for _ in range(4)))


def _alpha(half_life_s: float) -> float:
    return math.exp(math.log(0.5) / half_life_s)


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A 0-dim constant on ``device``, made once (no copy per step)."""
    return torch.tensor(value, dtype=dtype, device=device)


def _pow_alpha(alpha: float, exponent: torch.Tensor) -> torch.Tensor:
    return torch.pow(_const(alpha, exponent.dtype, exponent.device),
                     exponent)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as the reference computes it: XLA
    rewrites a division by a constant into a multiplication by the
    float32 reciprocal, and so does the port (and its kernels)."""
    return x * float(np.float32(1.0) / np.float32(c))


def update(state: EwmaState, duration_ms: torch.Tensor,
           num_bytes: torch.Tensor,
           fast_half_life_s: float = DEFAULT_FAST_HALF_LIFE_S,
           slow_half_life_s: float = DEFAULT_SLOW_HALF_LIFE_S) -> EwmaState:
    """One sample per session.  ``duration_ms``/``num_bytes`` shaped
    ``[batch]``; a non-positive ``num_bytes`` marks "no sample this
    step" and leaves that session's state untouched."""
    duration_ms = torch.clamp_min(
        duration_ms.to(state.fast_estimate.dtype), MIN_SAMPLE_DURATION_MS)
    bandwidth = 8000.0 * num_bytes / duration_ms
    weight = _div(duration_ms, 1000.0)
    valid = num_bytes > 0

    def one(alpha, est, total_w):
        adj = _pow_alpha(alpha, weight)
        new_est = adj * est + (1.0 - adj) * bandwidth
        new_w = total_w + weight
        return (torch.where(valid, new_est, est),
                torch.where(valid, new_w, total_w))

    fe, fw = one(_alpha(fast_half_life_s), state.fast_estimate,
                 state.fast_weight)
    se, sw = one(_alpha(slow_half_life_s), state.slow_estimate,
                 state.slow_weight)
    return EwmaState(fe, fw, se, sw)


def get_estimate(state: EwmaState,
                 fast_half_life_s: float = DEFAULT_FAST_HALF_LIFE_S,
                 slow_half_life_s: float = DEFAULT_SLOW_HALF_LIFE_S,
                 default_estimate_bps: float = DEFAULT_ESTIMATE_BPS
                 ) -> torch.Tensor:
    """Bias-corrected min(fast, slow) readout, shaped ``[batch]``."""

    def corrected(alpha, est, total_w):
        zero_factor = 1.0 - _pow_alpha(alpha, total_w)
        return torch.where(total_w > 0,
                           est / torch.clamp_min(zero_factor, 1e-12),
                           torch.zeros_like(est))

    fast = corrected(_alpha(fast_half_life_s), state.fast_estimate,
                     state.fast_weight)
    slow = corrected(_alpha(slow_half_life_s), state.slow_estimate,
                     state.slow_weight)
    est = torch.minimum(fast, slow)
    return torch.where(state.fast_weight > 0, est,
                       torch.full_like(est, default_estimate_bps))


def scan_samples(state: EwmaState, durations_ms: torch.Tensor,
                 num_bytes: torch.Tensor,
                 fast_half_life_s: float = DEFAULT_FAST_HALF_LIFE_S,
                 slow_half_life_s: float = DEFAULT_SLOW_HALF_LIFE_S):
    """Fold a time-major sample stream ``[T, batch]`` into the state;
    returns (final_state, estimates_over_time ``[T, batch]``)."""
    estimates = []
    for d, b in zip(durations_ms, num_bytes):
        state = update(state, d, b, fast_half_life_s, slow_half_life_s)
        estimates.append(get_estimate(state, fast_half_life_s,
                                      slow_half_life_s))
    if not estimates:
        return state, torch.zeros((0,) + tuple(state.fast_estimate.shape),
                                  dtype=state.fast_estimate.dtype,
                                  device=state.fast_estimate.device)
    return state, torch.stack(estimates)
