"""The port's threefry PRNG against ``jax.random``.

Parity level (a), byte-equal: keys, folded keys, split keys, raw 32-bit
words and float32 uniforms of ``lightgbm_tpu_torch.utils.prng`` equal
``jax.random``'s word for word (threefry2x32, partitionable mode, x64
off: the reference's settings).
"""
import jax
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.quantize import tree_key as ref_tree_key
from lightgbm_tpu_torch.ops.quantize import tree_key
from lightgbm_tpu_torch.utils import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 + 5]
DATA = [0, 1, 7, 2 ** 32 - 1]
SHAPES = [(1,), (7,), (1000, 2), (3, 5, 2)]


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_reference_prng_settings():
    """The contract assumes these settings of the reference's jax."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_equals_jax(seed):
    got = prng.PRNGKey(seed)
    assert got.dtype == torch.int64 and got.shape == (2,)
    assert np.array_equal(got.numpy(), _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_equals_jax(seed, data):
    got = prng.fold_in(prng.PRNGKey(seed), data)
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    assert np.array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_equal_jax(shape):
    for seed in SEEDS:
        for data in DATA:
            kj = jax.random.fold_in(jax.random.PRNGKey(seed), data)
            kt = prng.fold_in(prng.PRNGKey(seed), data)
            bits = prng.random_bits32(kt, shape)
            assert bits.shape == shape
            assert np.array_equal(bits.numpy(),
                                  _words(jax.random.bits(kj, shape)))
            u = prng.uniform(kt, shape)
            want = np.asarray(jax.random.uniform(kj, shape))
            assert u.dtype == torch.float32 and want.dtype == np.float32
            assert np.array_equal(u.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("num", [1, 2, 3, 7])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax(seed, num):
    got = prng.split(prng.PRNGKey(seed), num)
    assert got.dtype == torch.int64 and got.shape == (num, 2)
    want = jax.random.split(jax.random.PRNGKey(seed), num)
    assert np.array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain_and_draws_equal_jax(seed):
    """rank_xendcg's sequence: ``key, sub = split(key)`` on every call,
    then a uniform of the query layout's shape under ``sub``."""
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for _ in range(4):
        kj, sj = jax.random.split(kj)
        kt, st = prng.split(kt)
        assert np.array_equal(st.numpy(), _words(sj))
        want = np.asarray(jax.random.uniform(sj, (13, 61)))
        assert np.array_equal(prng.uniform(st, (13, 61)).numpy().view(
            np.int32), want.view(np.int32))
    assert np.array_equal(kt.numpy(), _words(kj))


def test_tree_key_sequence_over_five_trees():
    """The quantizer's per-tree keys: fold_in(base, 1), ..., (base, 5),
    the reference's device-counter sequence."""
    seed = 12345 & 0x7FFFFFFF
    base_j = jax.random.PRNGKey(seed)
    ctr = jax.numpy.uint32(0)
    base_t = prng.PRNGKey(seed)
    for tree_no in range(1, 6):
        kj, ctr = ref_tree_key(base_j, ctr)
        assert int(ctr) == tree_no
        assert np.array_equal(tree_key(base_t, tree_no).numpy(), _words(kj))


def test_tensor_data_and_device_argument():
    """fold_in takes a 0-d tensor as data; draws stay on the key's
    device."""
    key = prng.PRNGKey(9, device="cpu")
    assert torch.equal(prng.fold_in(key, torch.tensor(7)),
                       prng.fold_in(key, 7))
    assert prng.uniform(key, (4,)).device == key.device
    with pytest.raises(ValueError, match="uint32"):
        prng.fold_in(key, -1)
