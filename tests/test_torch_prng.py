"""repro_torch.prng against jax.random in the non-partitionable threefry
mode the golden artifacts were realized in: keys, splits, fold-ins, raw
bits and uniforms must be bit-equal, normals within 2 ULP (erfinv is a
polynomial whose fused multiply-adds XLA may round differently)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402

SEEDS = (0, 1, 42, 2**31 - 1, 987654321)
SHAPES = ((1,), (2,), (7,), (4, 5), (3, 3, 3), (1000,), (1001,))


def _key(seed):
    with jax.threefry_partitionable(False):
        return jax.random.PRNGKey(seed)


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_words(seed):
    assert np.array_equal(_words(_key(seed)), prng.PRNGKey(seed).numpy())


@pytest.mark.parametrize("num", (1, 2, 3, 5, 8))
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches(seed, num):
    with jax.threefry_partitionable(False):
        want = _words(jax.random.split(jax.random.PRNGKey(seed), num))
    assert np.array_equal(prng.split(prng.PRNGKey(seed), num).numpy(), want)


@pytest.mark.parametrize("data", (0, 7, 2**31 - 1, 2**31, 2**32 - 1))
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_fold_in_matches_as_uint32(seed, data):
    with jax.threefry_partitionable(False):
        want = _words(jax.random.fold_in(jax.random.PRNGKey(seed),
                                         np.uint32(data)))
    assert np.array_equal(prng.fold_in(prng.PRNGKey(seed), data).numpy(), want)


def test_fold_in_vectorized_over_data_and_keys():
    data = np.array([0, 5, 46340, 2**31 + 3], np.uint32)
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(3), 4)
        want = _words(jax.vmap(jax.random.fold_in)(keys, data))
    got = prng.fold_in(prng.split(prng.PRNGKey(3), 4),
                       torch.as_tensor(data.astype(np.int64)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_random_bits_matches(seed, shape):
    with jax.threefry_partitionable(False):
        want = _words(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      jnp.uint32))
    assert np.array_equal(prng.random_bits(prng.PRNGKey(seed), shape).numpy(),
                          want)


@pytest.mark.parametrize("bounds", ((0.0, 1.0), (0.3, 7.5), (500.0, 9500.0)))
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bit_equal(shape, bounds):
    lo, hi = bounds
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(11), shape,
                                             minval=lo, maxval=hi))
    got = prng.uniform(prng.PRNGKey(11), shape, lo, hi).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_batched_keys_match_vmap():
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(5), 6)
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9,)))(keys))
    got = prng.uniform(prng.split(prng.PRNGKey(5), 6), (9,)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", ((1,), (7,), (64, 10), (20001,)))
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_within_2_ulp(seed, shape):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 2
