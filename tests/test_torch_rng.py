"""repro_torch.rng against jax.random (threefry2x32, partitionable mode).

Integer outputs (keys, bits, randint, permutation), uniforms and
Bernoulli draws must be bit-exact.  normal and exponential go through erfinv / log1p, whose last
ulp differs between XLA and torch, so they compare within float32
rtol=1e-6, atol=1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import rng  # noqa: E402
from repro_torch.interop import key_from_numpy  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

SEEDS = (0, 7, 12345, 2**31 - 1, -3)


def _keys(seed, n=5):
    """The same batch of keys in both packages: jax [n, 2] uint32, torch."""
    with jax.threefry_partitionable(True):
        jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, key_from_numpy(np.asarray(jk))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in_bit_exact(seed):
    with jax.threefry_partitionable(True):
        jk = jax.random.PRNGKey(seed)
        tk = rng.PRNGKey(seed)
        assert np.array_equal(np.asarray(jk), tk.numpy())
        for num in (2, 5, 6):
            assert np.array_equal(np.asarray(jax.random.split(jk, num)),
                                  rng.split(tk, num).numpy())
        for data in (0, 1, 7, 13, 2**32 - 1):
            assert np.array_equal(np.asarray(jax.random.fold_in(jk, data)),
                                  rng.fold_in(tk, data).numpy())


def test_batched_keys_split_and_bits():
    jk, tk = _keys(3, n=4)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jk))
        assert np.array_equal(want, rng.split(tk, 3).numpy())
        bits = np.asarray(jax.vmap(
            lambda k: jax.random.bits(k, (3, 5), jnp.uint32))(jk))
        assert np.array_equal(bits.astype(np.int64),
                              rng.random_bits(tk, (3, 5)).numpy())


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.10, 0.11),
                                   (0.0, 2 * np.pi), (-0.05, 0.05),
                                   (0.0, 1000.0)])
def test_uniform_bit_exact(lo, hi):
    jk, tk = _keys(11, n=3)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (257, 3), minval=lo, maxval=hi))(jk))
    got = rng.uniform(tk, (257, 3), lo, hi).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(want, got)



@pytest.mark.parametrize("p", [0.0, 0.05, 0.15, 0.5, 1.0 / 3.0, 0.999, 1.0])
def test_bernoulli_bit_exact(p):
    """rs / ub participation and the fault draws: uniform < p in float32."""
    jk, tk = _keys(13, n=3)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.bernoulli(k, p, (4097,)))(jk))
    got = rng.bernoulli(tk, p, (4097,)).numpy()
    assert got.dtype == np.bool_
    assert np.array_equal(want, got)

@pytest.mark.parametrize("m", range(2, 9))
def test_randint_bit_exact_small_spans(m):
    jk, tk = _keys(m, n=64)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (), 0, m))(jk))
    assert np.array_equal(want, rng.randint(tk, (), 0, m).numpy())


def test_randint_bit_exact_wide_and_negative_spans():
    jk, tk = _keys(5, n=2)
    for lo, hi in ((-5, 100000), (0, 2**31 - 1), (-2**31, 2**31 - 1),
                   (7, 7), (3, 1)):
        with jax.threefry_partitionable(True):
            want = np.asarray(jax.vmap(
                lambda k: jax.random.randint(k, (333,), lo, hi))(jk))
        assert np.array_equal(want, rng.randint(tk, (333,), lo, hi).numpy()), \
            (lo, hi)


@pytest.mark.parametrize("n", (1, 12, 100, 4000))
def test_permutation_bit_exact(n):
    jk, tk = _keys(n, n=3)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(jk))
        arr = jnp.arange(n) * 3 + 1
        want_arr = np.asarray(jax.random.permutation(jk[0], arr))
    assert np.array_equal(want, rng.permutation(tk, n).numpy())
    got_arr = rng.permutation(tk[0], torch.arange(n) * 3 + 1).numpy()
    assert np.array_equal(want_arr, got_arr)


def test_normal_and_exponential_within_ulps():
    jk, tk = _keys(9, n=2)
    with jax.threefry_partitionable(True):
        n_want = np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (20000,)))(jk))
        e_want = np.asarray(jax.vmap(
            lambda k: jax.random.exponential(k, (20000,)))(jk))
    np.testing.assert_allclose(rng.normal(tk, (20000,)).numpy(), n_want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rng.exponential(tk, (20000,)).numpy(), e_want,
                               rtol=1e-6, atol=1e-6)


def test_prngkey_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        rng.PRNGKey(2**31)


# --- the draws of the Dirichlet partition ------------------------------
# gumbel is -log(-log(u)) and gamma's rejection loops read log and the
# normal's log1p, whose last ulp differs between XLA and torch (ROADMAP
# C.4): floats within rtol 1e-5, every index exact on these seeds.

def test_gumbel_within_ulps():
    jk, tk = _keys(21, n=3)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (4097,)))(jk))
    got = rng.gumbel(tk, (4097,)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("draws,n", [((30,), 40), ((7, 3), 5), ((1,), 1)])
def test_categorical_indices_exact(draws, n):
    """Batched keys over users, a prefix of draws per user, ties among
    the logits (equal classes)."""
    jk, tk = _keys(len(draws) * 100 + n, n=6)
    lg = np.log(np.random.default_rng(n).dirichlet(np.ones(4), 6)
                )[:, np.random.default_rng(1).integers(0, 4, n)]
    lg = lg.astype(np.float32)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.vmap(lambda k, l: jax.random.categorical(
            k, l, shape=draws))(jk, lg))
    got = rng.categorical(tk, torch.tensor(lg), draws).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("alpha", [0.05, 0.1, 0.5, 1.0, 2.5, 10.0])
@pytest.mark.parametrize("seed", [0, 7])
def test_gamma_and_loggamma(alpha, seed):
    """jax's Marsaglia-Tsang loops with its key layout (one split key per
    element), alpha below 1 boosted; both spaces."""
    with jax.threefry_partitionable(True):
        k = jax.random.PRNGKey(seed)
        g = np.asarray(jax.random.gamma(k, alpha, (12, 10)))
        lg = np.asarray(jax.random.loggamma(k, alpha, (12, 10)))
    tk = rng.PRNGKey(seed)
    np.testing.assert_allclose(rng.gamma(tk, alpha, (12, 10)).numpy(), g,
                               rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(rng.loggamma(tk, alpha, (12, 10)).numpy(), lg,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_dirichlet_proportions(seed):
    alpha = np.float32([0.1] * 10)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.random.dirichlet(jax.random.PRNGKey(seed),
                                               jnp.asarray(alpha), (12,)))
    got = rng.dirichlet(rng.PRNGKey(seed), torch.tensor(alpha), (12,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)
