"""The port's threefry twin (``core/prng.py``) against ``jax.random`` on
the CPU, to the bit: the raw generator, and the two draws the simulator
makes, ``staggered_joins`` (a permutation of a float32 ``linspace``)
and ``stable_ranks`` (a uniform draw).  Tolerance: none; every array is
compared by its bit pattern."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref
from hlsjs_p2p_wrapper_tpu_torch.core import prng
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port

SIZES = (1, 2, 255, 256, 2_048, 65_537)
SEEDS = (0, 3, 12345)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_staggered_joins_are_the_references(n, seed):
    got = port.staggered_joins(n, 60.0, seed, device="cpu").numpy()
    want = np.asarray(ref.staggered_joins(n, 60.0, seed))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_stable_ranks_are_the_references(n, seed):
    got = port.stable_ranks(n, seed, device="cpu").numpy()
    want = np.asarray(ref.stable_ranks(n, seed))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_bits_are_jax_random(seed):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key, _key(seed))
    jkey = jax.random.PRNGKey(seed)
    for num in (2, 3, 7):
        np.testing.assert_array_equal(
            prng.split(key, num),
            np.asarray(jax.random.key_data(jax.random.split(jkey, num))))
    np.testing.assert_array_equal(
        prng.random_bits(key, 1_001),
        np.asarray(jax.random.bits(jkey, (1_001,), jnp.uint32)))


def test_threefry_known_answer():
    """Random123's known-answer vector for threefry2x32 with 20 rounds:
    key (0x13198a2e, 0x03707344), counter (0x243f6a88, 0x85a308d3)."""
    x0, x1 = prng.threefry2x32(
        np.array([0x13198A2E, 0x03707344], np.uint32),
        np.array([0x243F6A88], np.uint32), np.array([0x85A308D3], np.uint32))
    assert (int(x0[0]), int(x1[0])) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("window_s", (60.0, 12.0, 7.0, 240.0))
def test_linspace_is_jnp_linspace(window_s):
    for n in (1, 2, 3, 100, 255, 1_000, 4_096, 65_537):
        np.testing.assert_array_equal(
            _bits(prng.linspace_f32(0.0, window_s, n)),
            _bits(jnp.linspace(0.0, window_s, n)))


def test_permutation_of_any_array_is_jax_random():
    x = np.arange(5_000, dtype=np.int32) * 7
    np.testing.assert_array_equal(
        prng.permutation(prng.PRNGKey(9), x),
        np.asarray(jax.random.permutation(jax.random.PRNGKey(9),
                                          jnp.asarray(x))))
    with pytest.raises(ValueError, match="1-D"):
        prng.permutation(prng.PRNGKey(0), np.zeros((2, 2)))
