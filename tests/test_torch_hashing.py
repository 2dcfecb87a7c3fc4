"""Port parity: ``repro_torch.core.hashing`` against ``repro.core.hashing``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import hashing as ref
from repro_torch.core import hashing as port

WORDS = np.concatenate([
    np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=np.uint32),
    np.random.RandomState(0).randint(0, 2**32, size=65536 - 5,
                                     dtype=np.uint64).astype(np.uint32),
])


@pytest.mark.parametrize("name", ["GOLDEN32", "NGRAM_BASE", "U32_MAX",
                                  "FNV_OFFSET32", "FNV_PRIME32", "_FMIX_C1",
                                  "_FMIX_C2"])
def test_constants_match_reference(name):
    assert getattr(port, name) == int(getattr(ref, name))


def test_bits_round_trip_through_numpy():
    t = port.u32_from_numpy(WORDS)
    assert t.dtype == torch.int32
    assert np.array_equal(port.u32_to_numpy(t), WORDS)
    vals = port.as_u32(t)
    assert int(vals.min()) >= 0 and int(vals.max()) <= 0xFFFFFFFF
    assert torch.equal(port.to_bits(vals), t)


def test_fmix32_matches_jnp_and_numpy_on_65536_words():
    got = port.u32_to_numpy(port.to_bits(port.fmix32(
        port.u32_from_numpy(WORDS))))
    assert np.array_equal(got, ref.fmix32_np(WORDS))
    assert np.array_equal(got, np.asarray(ref.fmix32(jnp.asarray(WORDS))))


@pytest.mark.parametrize("seed", [0, 1, 0x7045, 0xDEADBEEF, 0xFFFFFFFF])
def test_hash_u32_matches_reference(seed):
    got = port.u32_to_numpy(port.to_bits(port.hash_u32(
        port.u32_from_numpy(WORDS), seed)))
    assert np.array_equal(got, ref.hash_u32_np(WORDS, seed))
    jn = ref.hash_u32(jnp.asarray(WORDS), jnp.uint32(seed))
    assert np.array_equal(got, np.asarray(jn))


def test_hash_u32_takes_a_seed_tensor():
    seeds = ref.make_seeds(8)
    x = port.u32_from_numpy(WORDS[:512])[:, None]
    got = port.hash_u32(x, port.u32_from_numpy(seeds)[None, :])
    for m, s in enumerate(seeds):
        assert np.array_equal(
            port.u32_to_numpy(port.to_bits(got[:, m])),
            ref.hash_u32_np(WORDS[:512], s))


@pytest.mark.parametrize("c", [0, 1, 0xFFFF, 0x10000, 0x9E3779B9,
                               0xFFFFFFFF])
def test_mul32_is_the_uint32_product(c):
    x = port.as_u32(port.u32_from_numpy(WORDS))
    want = (WORDS.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
    assert np.array_equal(port.mul32(x, c).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("m,key", [(1, 0x5EED), (100, 0x5EED), (16, 7),
                                   (128, 0xFFFFFFFF)])
def test_make_seeds_matches_reference(m, key):
    assert np.array_equal(port.make_seeds(m, key), ref.make_seeds(m, key))
