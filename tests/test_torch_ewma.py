"""The PyTorch port's dual-EWMA estimator against the JAX reference
(ops/ewma.py) on seeded random (duration, bytes) streams, and against
the player's ABR contract number."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlsjs_p2p_wrapper_tpu.ops import ewma as ref
from hlsjs_p2p_wrapper_tpu_torch.ops import ewma as port

#: estimates: XLA's and PyTorch's float32 ``pow`` may round the last
#: ulp apart, and the recursion carries that through every later
#: sample; 1e-5 relative is ~80 ulps after 60 samples.
EST_RTOL = 1e-5
#: weights: sums of ``d * 0.001``.  XLA's CPU backend contracts
#: ``w + d * 0.001`` into one fused multiply-add (checked: its weights
#: equal a float64 FMA emulation exactly), the port rounds the product
#: and the sum apart: an ulp or two after 60 samples.
WEIGHT_RTOL = 1e-6


def _streams(seed, T=60, batch=48):
    rng = np.random.default_rng(seed)
    durations = rng.uniform(0.0, 4000.0, (T, batch)).astype(np.float32)
    nbytes = rng.uniform(0.0, 2e6, (T, batch)).astype(np.float32)
    nbytes[rng.random((T, batch)) < 0.3] = 0.0   # "no sample" steps
    return durations, nbytes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_matches_reference(seed):
    durations, nbytes = _streams(seed)
    batch = durations.shape[1]
    r_state, r_est = ref.scan_samples(ref.init_state(batch),
                                      jnp.asarray(durations),
                                      jnp.asarray(nbytes))
    p_state, p_est = port.scan_samples(
        port.init_state(batch, device="cpu"), torch.from_numpy(durations),
        torch.from_numpy(nbytes))
    np.testing.assert_allclose(p_est.numpy(), np.asarray(r_est),
                               rtol=EST_RTOL)
    for f in ("fast_estimate", "slow_estimate"):
        np.testing.assert_allclose(getattr(p_state, f).numpy(),
                                   np.asarray(getattr(r_state, f)),
                                   rtol=EST_RTOL, err_msg=f)
    for f in ("fast_weight", "slow_weight"):
        np.testing.assert_allclose(getattr(p_state, f).numpy(),
                                   np.asarray(getattr(r_state, f)),
                                   rtol=WEIGHT_RTOL, err_msg=f)


def test_default_estimate_before_any_sample():
    est = port.get_estimate(port.init_state(4, device="cpu"))
    assert est.dtype == torch.float32
    np.testing.assert_array_equal(est.numpy(), np.full(4, 5e5, np.float32))


def test_abr_contract_estimate():
    """128,000 B in 1 s reads back as 1,024,000 bps ± 4,000
    (tests/test_abr_contract.py, hls.js's controller contract)."""
    state = port.update(port.init_state(1, device="cpu"),
                        torch.tensor([1000.0]), torch.tensor([128_000.0]))
    est = float(port.get_estimate(state)[0])
    assert abs(est - 1_024_000.0) <= 4_000.0
