"""The port's threefry stream against ``jax.random``, bit for bit.

Both of jax's threefry modes: the partitionable one (the default of the
installed jax) and the original one the engine-parity golden was
captured with.  Shapes are every shape the engine draws, at the golden
fabric (``mrls(14, 3, 3)``: N=21, P=6, V=4, S=42, NR=168) and at the
paper's 11k-endpoint fabric (``mrls(614, 18, 18)``: N=921, P=36, V=4,
S=11052, NR=44208).  Batched keys ``[R, 2]`` (the engine's replica
axis) against ``jax.vmap`` of the same calls and against the port's
calls with each key alone.  Tolerance: zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

MODES = (True, False)
SEEDS = (0, 5, 123457)
# (N, P, V, S, NR) of the golden fabric and the Figure-5 fabric
FABRICS = ((21, 6, 4, 42, 168), (921, 36, 4, 11052, 44208))
SHAPES = sorted({s for N, P, V, S, NR in FABRICS
                 for s in ((N, P, V), (NR, P), (NR,), (S,), (N * P, V))})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of small tensor ops: one intra-op thread is as fast and
    leaves the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(seed):
    """The same key in both packages: a fold_in of a PRNGKey."""
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    tk = prng.fold_in(prng.prng_key(seed), 7)
    return jk, tk


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7, 123456, -1, 2**31 - 1])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(seed)),
                                  _u32(prng.prng_key(seed)))


@pytest.mark.parametrize("data", [0, 1, 3, 65536, 2**32 - 1])
def test_fold_in_matches_jax(data):
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(jk, data)),
            _u32(prng.fold_in(prng.prng_key(seed), data)))


@pytest.mark.parametrize("partitionable", MODES)
@pytest.mark.parametrize("num", [2, 3, 4, 5])
def test_split_matches_jax(partitionable, num):
    with jax.threefry_partitionable(partitionable):
        for seed in SEEDS:
            jk, tk = _keys(seed)
            np.testing.assert_array_equal(
                np.asarray(jax.random.split(jk, num)),
                _u32(prng.split(tk, num, partitionable=partitionable)))


@pytest.mark.parametrize("partitionable", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_matches_jax(partitionable, shape):
    with jax.threefry_partitionable(partitionable):
        for seed in SEEDS[:2]:
            jk, tk = _keys(seed)
            want = np.asarray(jax.random.uniform(jk, shape))
            got = prng.uniform(tk, shape, partitionable=partitionable).numpy()
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


@pytest.mark.parametrize("partitionable", MODES)
@pytest.mark.parametrize("shape,maxval", [
    ((168,), 256), ((44208,), 256), ((42,), 42), ((11052,), 11052),
    ((13, 5), 1000003), ((9,), 2**31 - 1)], ids=str)
def test_randint_matches_jax(partitionable, shape, maxval):
    with jax.threefry_partitionable(partitionable):
        for seed in SEEDS:
            jk, tk = _keys(seed)
            want = np.asarray(jax.random.randint(jk, shape, 0, maxval,
                                                 dtype=jnp.int32))
            got = prng.randint(tk, shape, 0, maxval,
                               partitionable=partitionable).numpy()
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_randint_negative_range_matches_jax():
    jk, tk = _keys(3)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jk, (50,), -5, 3, dtype=jnp.int32)),
        prng.randint(tk, (50,), -5, 3).numpy())


def test_out_of_range_arguments_raise():
    with pytest.raises(ValueError):
        prng.prng_key(2**31)
    with pytest.raises(ValueError):
        prng.fold_in(prng.prng_key(0), -1)
    with pytest.raises(ValueError):
        prng.randint(prng.prng_key(0), (3,), 0, 2**31)


# ---------------------------------------------------------------------- #
# batched keys (a replica axis): each key's draws are its own call's
# ---------------------------------------------------------------------- #
REPLICA_SEEDS = (0, 3, 9)


def _batched_keys(pt):
    """The same three keys in both packages, stacked: ``[3, 2]``."""
    with jax.threefry_partitionable(pt):
        jk = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(1), s)
                        for s in REPLICA_SEEDS])
    tk = torch.stack([prng.fold_in(prng.prng_key(1), s)
                      for s in REPLICA_SEEDS])
    return jk, tk


@pytest.mark.parametrize("partitionable", MODES)
@pytest.mark.parametrize("shape", [(5,), (21, 6, 4), (168, 6), (7, 3)],
                         ids=str)
def test_batched_draws_match_vmap_and_stacked_calls(partitionable, shape):
    """uniform, randint and random_bits with keys ``[3, 2]`` give
    ``[3, *shape]``: bitwise ``jax.vmap`` of the call and the port's
    calls with each key alone (the original mode halves the counter axis
    alone, not the batch)."""
    jk, tk = _batched_keys(partitionable)
    with jax.threefry_partitionable(partitionable):
        want_u = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, shape))(jk))
        want_i = np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, shape, 0, 37))(jk))
    got_u = prng.uniform(tk, shape, partitionable=partitionable).numpy()
    got_i = prng.randint(tk, shape, 0, 37, partitionable=partitionable)
    got_b = prng.random_bits(tk, shape, partitionable=partitionable)
    assert got_u.shape == got_i.shape == (3,) + shape
    np.testing.assert_array_equal(got_u.view(np.uint32),
                                  want_u.view(np.uint32))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    for i in range(3):
        for got, one in (
                (got_u[i], prng.uniform(tk[i], shape,
                                        partitionable=partitionable)),
                (got_i[i], prng.randint(tk[i], shape, 0, 37,
                                        partitionable=partitionable)),
                (got_b[i], prng.random_bits(tk[i], shape,
                                            partitionable=partitionable))):
            np.testing.assert_array_equal(np.asarray(got), one.numpy())


@pytest.mark.parametrize("partitionable", MODES)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_batched_split_matches_vmap(partitionable, num):
    jk, tk = _batched_keys(partitionable)
    with jax.threefry_partitionable(partitionable):
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(jk))
    got = prng.split(tk, num, partitionable=partitionable)
    assert got.shape == (3, num, 2)
    np.testing.assert_array_equal(_u32(got), want)
    for i in range(3):
        assert torch.equal(got[i], prng.split(tk[i], num,
                                              partitionable=partitionable))
    # two batch axes
    deep = prng.split(tk.reshape(3, 1, 2), num, partitionable=partitionable)
    assert torch.equal(deep.reshape(got.shape), got)


def test_fold_in_takes_one_key():
    _, tk = _batched_keys(True)
    with pytest.raises(ValueError, match="one key"):
        prng.fold_in(tk, 1)
