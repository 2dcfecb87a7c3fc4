"""Port parity for the staged kernels K3 (n-gram hashes), K4 (minhash) and
K5 (band fold), and for ``kernels.ops``.

Each kernel's plain version is held against the reference's Pallas
kernel in interpret mode, bit for bit, at the shapes of the reference's
own sweeps (``test_kernels.py``).  K3's hashes are compared with the
Pallas kernel only where ``valid`` is set: its halo is clamped at the
last tile, so its windows past column L - n read the tile's own tokens
where the port (and the jnp reference) read zeros; those positions are
never valid.  The CUDA kernels are held against the plain versions in
``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.kernels.ops as ref_ops
from repro.core import shingle as ref_shingle
from repro.core.verify import SignatureVerifier as RefSignatureVerifier
from repro.kernels.bandfold import band_values as ref_band_values
from repro.kernels.minhash import minhash_signatures as ref_minhash
from repro.kernels.ngram import ngram_hashes as ref_ngram_hashes
from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy
from repro_torch.kernels import bandfold as k5
from repro_torch.kernels import minhash as k4
from repro_torch.kernels import ngram as k3
from repro_torch.kernels import ops


def _words(rng, *shape):
    return rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


# -- K3: n-gram hashes ----------------------------------------------------------

# (D, L, n): L < n, L == n, one and several Pallas tiles of 256.
K3_CASES = [(1, 8, 2), (3, 5, 8), (6, 8, 8), (40, 37, 5), (12, 256, 8),
            (7, 300, 8), (5, 257, 3), (9, 100, 2)]


@pytest.mark.parametrize("D,L,n", K3_CASES)
def test_ngram_plain_matches_pallas_interpret_and_jnp(D, L, n):
    rng = np.random.RandomState(D * 1000 + L)
    tokens = _words(rng, D, L)
    lengths = rng.randint(0, L + 1, size=D).astype(np.int32)
    lengths[0] = L
    if D > 2:
        lengths[1:3] = [0, 1]
    hashes, valid = k3.ngram_hashes_plain(u32_from_numpy(tokens),
                                          torch.from_numpy(lengths), n=n)
    got, valid = u32_to_numpy(hashes), valid.numpy()
    pk, pvalid = ref_ngram_hashes(jnp.asarray(tokens), jnp.asarray(lengths),
                                  n=n)
    assert np.array_equal(valid, np.asarray(pvalid))
    assert np.array_equal(got[valid], np.asarray(pk)[valid])
    jh, jvalid = ref_shingle.ngram_hashes(jnp.asarray(tokens),
                                          jnp.asarray(lengths), n=n)
    assert np.array_equal(got, np.asarray(jh))
    assert np.array_equal(valid, np.asarray(jvalid))


def test_ngram_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.RandomState(3)
    tokens = u32_from_numpy(_words(rng, 6, 20))
    lengths = torch.tensor([0, 1, 5, 8, 19, 20], dtype=torch.int32)
    k3.launches = 0
    for g, w in zip(k3.ngram_hashes(tokens, lengths, n=4),
                    k3.ngram_hashes_plain(tokens, lengths, n=4)):
        assert torch.equal(g, w)
    assert k3.launches == 0


def test_ngram_wrapper_rejects_what_the_kernel_does_not_take():
    tokens = torch.zeros((4, 8), dtype=torch.int32)
    lengths = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        k3.ngram_hashes(tokens.long(), lengths)
    with pytest.raises(ValueError):
        k3.ngram_hashes(tokens, lengths[:3])
    with pytest.raises(ValueError):
        k3.ngram_hashes(tokens, lengths, n=0)
    with pytest.raises(ValueError, match="no kernel"):
        k3.ngram_hashes(tokens.to("meta"), lengths.to("meta"))


# -- K4: minhash signatures ----------------------------------------------------

# (D, L, M): M = 1, M = 130 (more seeds than the kernel's 128 threads).
K4_CASES = [(1, 4, 1), (5, 33, 7), (30, 200, 130), (8, 128, 100),
            (13, 129, 64), (2, 10, 3)]


@pytest.mark.parametrize("D,L,M", K4_CASES)
def test_minhash_plain_matches_pallas_interpret(D, L, M):
    rng = np.random.RandomState(D + L + M)
    ng = _words(rng, D, L)
    valid = rng.rand(D, L) < 0.8
    valid[0] = False  # a row with no valid position
    seeds = _words(rng, M)
    got = k4.minhash_signatures_plain(u32_from_numpy(ng),
                                      torch.from_numpy(valid),
                                      u32_from_numpy(seeds))
    want = ref_minhash(jnp.asarray(ng), jnp.asarray(valid),
                       jnp.asarray(seeds))
    assert np.array_equal(u32_to_numpy(got), np.asarray(want))
    assert np.all(u32_to_numpy(got)[0] == 0xFFFFFFFF)


def test_minhash_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.RandomState(4)
    ng = u32_from_numpy(_words(rng, 5, 30))
    valid = torch.from_numpy(rng.rand(5, 30) < 0.5)
    seeds = u32_from_numpy(_words(rng, 9))
    k4.launches = 0
    assert torch.equal(k4.minhash_signatures(ng, valid, seeds),
                       k4.minhash_signatures_plain(ng, valid, seeds))
    assert k4.launches == 0


def test_minhash_wrapper_rejects_what_the_kernel_does_not_take():
    ng = torch.zeros((4, 8), dtype=torch.int32)
    valid = torch.ones((4, 8), dtype=torch.bool)
    seeds = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        k4.minhash_signatures(ng, valid.int(), seeds)
    with pytest.raises(ValueError):
        k4.minhash_signatures(ng, valid[:, :5], seeds)
    with pytest.raises(ValueError):
        k4.minhash_signatures(ng, valid, seeds[:0])
    with pytest.raises(ValueError, match="no kernel"):
        k4.minhash_signatures(ng.to("meta"), valid.to("meta"),
                              seeds.to("meta"))


# -- K5: band fold --------------------------------------------------------------

# (D, r, b): r from 1 to 8.
K5_CASES = [(1, 1, 1), (50, 2, 50), (7, 3, 5), (20, 4, 30), (3, 5, 2),
            (11, 8, 13), (64, 7, 9)]


@pytest.mark.parametrize("D,r,b", K5_CASES)
def test_band_values_plain_matches_pallas_interpret(D, r, b):
    rng = np.random.RandomState(D * 7 + r)
    sig = _words(rng, D, r * b)
    got = k5.band_values_plain(u32_from_numpy(sig), r)
    want = ref_band_values(jnp.asarray(sig), r)
    assert got.shape == (D, b, 2)
    assert np.array_equal(u32_to_numpy(got), np.asarray(want))


def test_band_values_wrapper_on_cpu_runs_the_plain_version():
    sig = u32_from_numpy(_words(np.random.RandomState(5), 6, 12))
    k5.launches = 0
    assert torch.equal(k5.band_values(sig, 3), k5.band_values_plain(sig, 3))
    assert k5.launches == 0


def test_band_values_wrapper_rejects_what_the_kernel_does_not_take():
    sig = torch.zeros((4, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible"):
        k5.band_values(sig, 3)
    with pytest.raises(TypeError):
        k5.band_values(sig.long(), 2)
    with pytest.raises(ValueError, match="no kernel"):
        k5.band_values(sig.to("meta"), 2)


# -- ops ----------------------------------------------------------------------------

def test_ops_exports_the_ported_kernels_under_the_reference_names():
    ported = set(ops.__all__) - {"pair_counts"}
    assert ported == set(ref_ops.__all__)
    assert ops.ngram_hashes is k3.ngram_hashes
    assert ops.minhash_signatures is k4.minhash_signatures
    assert ops.band_values is k5.band_values


def test_ops_staged_chain_matches_pallas_chain():
    rng = np.random.RandomState(6)
    D, L, M, n, r = 9, 40, 20, 4, 2
    tokens = _words(rng, D, L)
    lengths = np.array([0, 1, 3, 4, 5, 20, 39, 40, 40], dtype=np.int32)
    seeds = _words(rng, M)
    ng, valid = ops.ngram_hashes(u32_from_numpy(tokens),
                                 torch.from_numpy(lengths), n=n)
    sig = ops.minhash_signatures(ng, valid, u32_from_numpy(seeds))
    bands = ops.band_values(sig, r)
    png, pvalid = ref_ops.ngram_hashes(jnp.asarray(tokens),
                                       jnp.asarray(lengths), n=n)
    psig = ref_ops.minhash_signatures(png, pvalid, jnp.asarray(seeds))
    assert np.array_equal(u32_to_numpy(sig), np.asarray(psig))
    assert np.array_equal(u32_to_numpy(bands),
                          np.asarray(ref_ops.band_values(psig, r)))


def test_ops_indexed_pair_estimate_is_the_numpy_estimator():
    rng = np.random.RandomState(7)
    D, M, P = 30, 100, 200
    sig = rng.randint(0, 3, size=(D, M)).astype(np.uint32)
    a = rng.randint(0, D, size=P).astype(np.int64)
    b = rng.randint(0, D, size=P).astype(np.int64)
    got = ops.indexed_pair_estimate(u32_from_numpy(sig), torch.from_numpy(a),
                                    torch.from_numpy(b)).numpy()
    want = RefSignatureVerifier(sig, backend="numpy")(np.stack([a, b], 1))
    assert got.dtype == np.float32 and np.array_equal(got, want)
