"""The port's threefry streams (``synthpy_tpu_torch.random``, kernel K10's
plain version) against ``jax.random``.

Keys (``PRNGKey``, ``split``, ``fold_in``), ``bits`` and ``uniform`` are
bit-equal: the same threefry-2x32 hash of the same counters, and the same
exact float arithmetic. ``normal`` is XLA's float32 ``erf_inv`` on
``log1p``, which PyTorch's CPU and XLA's CPU compute to different last
places: held within 4 ulp, with at least 90% of the draws bit-equal
(observed: <= 3 ulp, ~95% equal over 2^18 draws). ``permutation`` and
``choice(replace=False)`` are bit-equal (stable sorts by the same bits).
The port was written against ``jax_threefry_partitionable=True``; the
guard test fails loudly if that mode changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu_torch import convert
from synthpy_tpu_torch import random as tr
from synthpy_tpu_torch.kernels import random as kr

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

SEEDS = [0, 7, 123456789, -3, 2**32 - 1]
SHAPES = [(1,), (7,), (3, 5, 7), (70001,), (2, 3, 4, 5)]


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 units in the last place."""
    def ordinal(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordinal(a) - ordinal(b))


def test_partitionable_mode_is_the_one_ported():
    assert jax.config.jax_threefry_partitionable is True, (
        "synthpy_tpu_torch.random reproduces jax.random with "
        "jax_threefry_partitionable=True (counters = flat index); JAX's "
        "mode has changed, so the port's streams no longer match")


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = tr.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for num in (2, 5):
        np.testing.assert_array_equal(tr.split(tk, num).numpy(),
                                      np.asarray(jax.random.split(jk, num)))
    for d in (0, 1, 37, 2**31 + 5):
        np.testing.assert_array_equal(tr.fold_in(tk, d).numpy(),
                                      np.asarray(jax.random.fold_in(jk, d)))
    # keys taken from JAX, raw or typed, carry across
    sub = jax.random.split(jk)[1]
    assert tr.key_data(convert.key(sub)) == tuple(
        int(v) for v in np.asarray(sub))
    assert tr.key_data(convert.key(jax.random.key(abs(seed) % 2**31))) == (
        0, abs(seed) % 2**31)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_and_uniform_bit_equal(seed, shape):
    jk = jax.random.PRNGKey(seed)
    tk = tr.PRNGKey(seed)
    np.testing.assert_array_equal(tr.bits(tk, shape, device="cpu").numpy(),
                                  np.asarray(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(
        tr.uniform(tk, shape, device="cpu").numpy(),
        np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        tr.uniform(tk, shape, minval=-0.5, maxval=0.5, device="cpu").numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=-0.5, maxval=0.5)))


def test_draws_past_two_to_the_sixteen():
    """A draw crossing 2^16 and 2^22 (the plain version's chunk) of one
    key equals JAX's."""
    jk, tk = jax.random.PRNGKey(11), tr.PRNGKey(11)
    n = kr.CHUNK + 70000
    np.testing.assert_array_equal(tr.bits(tk, (n,), device="cpu").numpy(),
                                  np.asarray(jax.random.bits(jk, (n,))))


def test_counters_past_two_to_the_32():
    """Flat indices with a non-zero high word: the counter pair is
    (hi32(i), lo32(i)), checked against JAX's threefry on a large
    index."""
    from jax._src import prng as jprng

    i = np.array([2**32 + 5, 3 * 2**32 + 2**31], dtype=np.uint64)
    k = tr.key_data(tr.PRNGKey(9))
    y0, y1 = kr.hash_plain(k[0], k[1], torch.from_numpy(
        (i >> 32).astype(np.int64)), torch.from_numpy(
        (i & 0xFFFFFFFF).astype(np.int64)))
    j0, j1 = jprng.threefry_2x32(
        jnp.asarray(np.asarray(k, np.uint32)),
        jnp.asarray(np.concatenate([i >> 32, i & 0xFFFFFFFF]).astype(
            np.uint32)))[None].reshape(2, -1)
    np.testing.assert_array_equal(y0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(y1.numpy(), np.asarray(j1))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_within_four_ulp(seed):
    n = 1 << 18
    a = tr.normal(tr.PRNGKey(seed), (n,), device="cpu").numpy()
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,)))
    d = _ulp(a, b)
    assert d.max() <= 4, d.max()
    assert (d == 0).mean() >= 0.90, (d == 0).mean()


def test_erf_inv_edges():
    x = torch.tensor([0.0, -0.5, 0.5, 0.999, -0.99999994, 1.0, -1.0])
    y = kr.erf_inv(x).numpy()
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x.numpy())))
    assert (y[:5] != 0).sum() == 4 and y[0] == 0.0
    np.testing.assert_array_equal(np.sign(y), np.sign(want))
    assert np.isfinite(y).all()
    d = _ulp(y[:5], want[:5])
    assert d.max() <= 4, d


@pytest.mark.parametrize("n", [1, 10, 3000])
def test_permutation_and_choice_bit_equal(n):
    jk, tk = jax.random.PRNGKey(4), tr.PRNGKey(4)
    np.testing.assert_array_equal(
        tr.permutation(tk, n, device="cpu").numpy(),
        np.asarray(jax.random.permutation(jk, n)))
    k = min(n, 7)
    np.testing.assert_array_equal(
        tr.choice(tk, n, (k,), device="cpu").numpy(),
        np.asarray(jax.random.choice(jk, n, (k,), replace=False)))
    with pytest.raises(ValueError, match="larger sample"):
        tr.choice(tk, n, (n + 1,), device="cpu")


def test_plane_rows_are_fold_in_draws():
    """uniform_rows_plain, the plain K2 / K9 dither draw, is a vmap of
    uniform over fold_in keys."""
    key = jax.random.PRNGKey(7)
    planes = torch.tensor([0, 3, 9, 517])
    rows = kr.uniform_rows_plain(tr.key_data(convert.key(key)), planes, 11,
                                 -0.5, 0.5)
    want = jax.vmap(lambda g: jax.random.uniform(
        jax.random.fold_in(key, g), (11,), minval=-0.5, maxval=0.5))(
        jnp.asarray(planes.numpy()))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want))


def test_draws_at_an_offset_are_the_tail_of_one_draw():
    """``draw(offset=)`` gives indices offset .. offset+n-1 of one stream
    (the card test draws past 2^32 this way)."""
    full = kr.draw_plain((5, 9), 300, "normal")
    part = kr.draw_plain((5, 9), 100, "normal", offset=200)
    assert torch.equal(full[200:], part)
    hi = kr.draw_plain((5, 9), 3, "bits", offset=2**32 + 7)
    y0, y1 = kr.hash_plain(5, 9, torch.ones(3, dtype=torch.int64),
                           torch.arange(7, 10, dtype=torch.int64))
    assert torch.equal(hi.view(torch.int32).to(torch.int64) & kr.MASK,
                       y0 ^ y1)
