"""Port parity for the signature stage and its two kernels.

The port's shingling, n-gram hashes, signatures and band values are held
against ``repro``'s functions bit for bit; K1's and K2's plain versions
against the Pallas kernels run in interpret mode.  The CUDA kernels
themselves are held against their plain versions in ``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import jaccard as ref_jaccard
from repro.core import lsh as ref_lsh
from repro.core import minhash as ref_minhash
from repro.core import shingle as ref_shingle
from repro.core.verify import SignatureVerifier as RefSignatureVerifier
from repro.data import inject_near_duplicates as ref_inject
from repro.data import make_i2b2_like as ref_notes
from repro.kernels.fused_ingest import fused_ingest as ref_fused_ingest
from repro.kernels.sigjaccard import indexed_pair_estimate
from repro.kernels.sigjaccard import pair_estimate as ref_pair_estimate
from repro_torch.core import jaccard, lsh, minhash, shingle
from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy
from repro_torch.kernels import fused_ingest as k1
from repro_torch.kernels import sigjaccard as k2


def _texts():
    notes, _ = ref_inject(ref_notes(12, seed=3), 6, seed=4)
    return notes + ["", "Tiny note.", "Running ran runs, quickly!"]


def _packed(D, L, M, seed, lengths=None):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 2**32, size=(D, L), dtype=np.uint64)
    tokens = tokens.astype(np.uint32)
    if lengths is None:
        lengths = rng.randint(0, L + 1, size=D)
    lengths = np.asarray(lengths, dtype=np.int32)
    seeds = rng.randint(0, 2**32, size=M, dtype=np.uint64).astype(np.uint32)
    return tokens, lengths, seeds


def _t(a):
    """numpy uint32 -> int32 word tensor; numpy int -> tensor."""
    if a.dtype == np.uint32:
        return u32_from_numpy(a)
    return torch.from_numpy(np.ascontiguousarray(a))


# -- host shingling -----------------------------------------------------------

def test_tokenize_and_stem_match_reference():
    for text in _texts():
        assert shingle.tokenize(text) == ref_shingle.tokenize(text)
        assert shingle.tokenize(text, do_stem=False) == \
            ref_shingle.tokenize(text, do_stem=False)
        for w in ref_shingle.tokenize(text, do_stem=False):
            assert shingle.stem(w) == ref_shingle.stem(w)


def test_token_ids_and_ngram_sets_match_reference():
    for text in _texts():
        toks = ref_shingle.tokenize(text)
        assert np.array_equal(shingle.token_ids(toks),
                              ref_shingle.token_ids(toks))
        assert shingle.token_ids(toks).dtype == np.uint32
        for n in (1, 3, 8):
            assert shingle.ngram_set(toks, n) == ref_shingle.ngram_set(toks, n)


@pytest.mark.parametrize("max_len", [None, 5, 256])
def test_pack_documents_matches_reference(max_len):
    docs = [ref_shingle.tokenize(t) for t in _texts()]
    got = shingle.pack_documents(docs, max_len)
    want = ref_shingle.pack_documents(docs, max_len)
    assert np.array_equal(got.tokens, want.tokens)
    assert np.array_equal(got.lengths, want.lengths)
    assert got.tokens.dtype == np.uint32 and got.lengths.dtype == np.int32


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4097])
def test_pow2_bucket_matches_reference(n):
    assert shingle.pow2_bucket(n) == ref_shingle.pow2_bucket(n)
    assert shingle.pow2_bucket(n, floor=8) == ref_shingle.pow2_bucket(n, floor=8)


# -- staged tensor chain against the jnp functions ----------------------------

@pytest.mark.parametrize("n", [1, 3, 8])
def test_ngram_hashes_match_jnp(n):
    tokens, lengths, _ = _packed(10, 24, 4, seed=n,
                                 lengths=[0, 1, 2, 5, 7, 8, 9, 23, 24, 24])
    h, valid = shingle.ngram_hashes(_t(tokens), _t(lengths), n=n)
    rh, rvalid = ref_shingle.ngram_hashes(jnp.asarray(tokens),
                                          jnp.asarray(lengths), n=n)
    assert np.array_equal(u32_to_numpy(h), np.asarray(rh))
    assert np.array_equal(valid.numpy(), np.asarray(rvalid))


def test_signatures_match_jnp():
    tokens, lengths, seeds = _packed(9, 30, 20, seed=1)
    lengths[0] = 0
    ng, valid = ref_shingle.ngram_hashes_np(tokens, lengths)
    got = minhash.signatures(_t(ng), torch.from_numpy(valid), _t(seeds),
                             m_chunk=8)
    want = ref_minhash.signatures(jnp.asarray(ng), jnp.asarray(valid),
                                  jnp.asarray(seeds))
    assert np.array_equal(u32_to_numpy(got), np.asarray(want))
    assert np.all(u32_to_numpy(got)[0] == 0xFFFFFFFF)


@pytest.mark.parametrize("r", [1, 2, 5])
def test_band_values_match_jnp(r):
    rng = np.random.RandomState(r)
    sig = rng.randint(0, 2**32, size=(7, 20), dtype=np.uint64).astype(np.uint32)
    got = lsh.band_values(_t(sig), r)
    want = ref_lsh.band_values(jnp.asarray(sig), r)
    assert got.shape == (7, 20 // r, 2)
    assert np.array_equal(u32_to_numpy(got), np.asarray(want))


def test_estimate_jaccard_is_the_numpy_estimator():
    rng = np.random.RandomState(5)
    a = rng.randint(0, 3, size=(500, 100)).astype(np.uint32)
    b = rng.randint(0, 3, size=(500, 100)).astype(np.uint32)
    got = minhash.estimate_jaccard(_t(a), _t(b)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, (a == b).mean(axis=-1, dtype=np.float32))
    jn = np.asarray(ref_minhash.estimate_jaccard(jnp.asarray(a),
                                                 jnp.asarray(b)))
    assert np.max(np.abs(got - jn)) <= 1e-6  # jnp may round 1 ulp apart


def test_estimate_from_counts_rounds_every_count_at_m100():
    counts = torch.arange(101, dtype=torch.int32)
    got = minhash.estimate_from_counts(counts, 100).numpy()
    want = np.arange(101, dtype=np.float32) / np.float32(100)
    assert np.array_equal(got, want)
    assert got[40] == np.float32(0.4)


def test_default_seeds_match_reference():
    assert np.array_equal(minhash.default_seeds(100),
                          ref_minhash.default_seeds(100))


def test_lsh_params_and_candidate_probability_match_reference():
    p, rp = lsh.LSHParams(), ref_lsh.LSHParams()
    assert (p.num_hashes, p.rows_per_band, p.ngram, p.num_bands) == \
        (rp.num_hashes, rp.rows_per_band, rp.ngram, rp.num_bands)
    assert p.threshold_estimate() == rp.threshold_estimate()
    s = np.linspace(0.0, 1.0, 11)
    got = lsh.candidate_probability(s, 2, 50).numpy()
    want = np.asarray(ref_lsh.candidate_probability(s, 2, 50))
    assert np.allclose(got, want, atol=1e-6)  # reference computes in f32


def test_jaccard_functions_match_reference():
    docs = [ref_shingle.tokenize(t) for t in _texts()]
    for a, b in [(0, 12), (1, 2), (14, 14), (13, 15)]:
        assert jaccard.exact_jaccard_docs(docs[a], docs[b]) == \
            ref_jaccard.exact_jaccard_docs(docs[a], docs[b])
    assert jaccard.exact_jaccard(set(), set()) == \
        ref_jaccard.exact_jaccard(set(), set())
    rng = np.random.RandomState(2)
    sig = rng.randint(0, 4, size=(20, 100)).astype(np.uint32)
    pairs = rng.randint(0, 20, size=(64, 2))
    got = jaccard.pairwise_estimate(_t(sig), torch.from_numpy(pairs)).numpy()
    assert np.array_equal(got, ref_jaccard.pairwise_estimate_np(sig, pairs))


# -- K1: fused ingest ----------------------------------------------------------

K1_CASES = [
    # (D, L, M, n, r, lengths): lengths 0 and 1-7 are short documents.
    (12, 40, 16, 8, 2, [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 39, 40]),
    (5, 5, 16, 8, 2, [0, 1, 3, 5, 5]),          # L < n
    (6, 33, 15, 3, 3, [0, 2, 3, 4, 20, 33]),    # M not a power of two
]


@pytest.mark.parametrize("D,L,M,n,r,lengths", K1_CASES)
def test_fused_ingest_plain_matches_pallas_interpret(D, L, M, n, r, lengths):
    tokens, lengths, seeds = _packed(D, L, M, seed=D + L, lengths=lengths)
    sig, bands, valid = k1.fused_ingest_plain(_t(tokens), _t(lengths),
                                              _t(seeds), n=n, r=r)
    rsig, rbands, rvalid = ref_fused_ingest(
        jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(seeds),
        n=n, r=r)
    assert np.array_equal(u32_to_numpy(sig), np.asarray(rsig))
    assert np.array_equal(u32_to_numpy(bands), np.asarray(rbands))
    assert np.array_equal(valid.numpy(), np.asarray(rvalid))
    assert np.all(u32_to_numpy(sig)[lengths == 0] == 0xFFFFFFFF)


def test_fused_ingest_wrapper_on_cpu_runs_the_plain_version():
    tokens, lengths, seeds = _packed(8, 20, 10, seed=9)
    k1.launches = 0
    got = k1.fused_ingest(_t(tokens), _t(lengths), _t(seeds), n=4, r=2)
    want = k1.fused_ingest_plain(_t(tokens), _t(lengths), _t(seeds), n=4, r=2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert k1.launches == 0


def test_fused_ingest_wrapper_rejects_what_the_kernel_does_not_take():
    tokens, lengths, seeds = _packed(4, 8, 10, seed=2)
    with pytest.raises(TypeError):
        k1.fused_ingest(_t(tokens).long(), _t(lengths), _t(seeds))
    with pytest.raises(ValueError):
        k1.fused_ingest(_t(tokens), _t(lengths), _t(seeds), r=3)
    with pytest.raises(ValueError):
        k1.fused_ingest(_t(tokens), _t(lengths)[:3], _t(seeds))


# -- K2: pair agreement counts -------------------------------------------------

def test_pair_counts_plain_matches_pallas_interpret_and_numpy_verifier():
    rng = np.random.RandomState(11)
    D, M, P = 40, 100, 300
    sig = rng.randint(0, 3, size=(D, M)).astype(np.uint32)
    a = rng.randint(0, D, size=P).astype(np.int64)
    b = rng.randint(0, D, size=P).astype(np.int64)
    b[:20] = a[:20]  # identical rows: count M
    counts = k2.pair_counts_plain(_t(sig), _t(a), _t(b)).numpy()
    est = np.asarray(indexed_pair_estimate(jnp.asarray(sig), jnp.asarray(a),
                                           jnp.asarray(b)))
    assert counts.dtype == np.int32
    assert np.array_equal(counts, np.rint(est * M).astype(np.int32))
    ours = minhash.estimate_from_counts(torch.from_numpy(counts), M).numpy()
    assert np.max(np.abs(ours - est)) <= 1e-6  # the Pallas body is 1 ulp off
    want = RefSignatureVerifier(sig, backend="numpy")(np.stack([a, b], 1))
    assert np.array_equal(ours, want)
    assert np.all(counts[:20] == M)


@pytest.mark.parametrize("P,M", [(300, 100), (37, 7), (5, 130)])
def test_pair_estimate_matches_pallas_interpret_and_numpy_verifier(P, M):
    rng = np.random.RandomState(P + M)
    a = rng.randint(0, 3, size=(P, M)).astype(np.uint32)
    b = rng.randint(0, 3, size=(P, M)).astype(np.uint32)
    b[:4] = a[:4]  # identical rows: count M
    before = k2.masked_launches
    got = k2.pair_estimate(_t(a), _t(b)).numpy()
    assert k2.masked_launches == before  # the CPU runs the plain version
    counts = k2.masked_pair_counts_plain(_t(a), _t(b),
                                         torch.ones(P, dtype=torch.bool))
    est = np.asarray(ref_pair_estimate(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == np.float32 and got.shape == (P,)
    assert np.array_equal(counts.numpy(), np.rint(est * M).astype(np.int32))
    assert np.max(np.abs(got - est)) <= 1e-6  # the Pallas body is 1 ulp off
    sig = np.concatenate([a, b])
    pairs = np.stack([np.arange(P), P + np.arange(P)], 1)
    want = RefSignatureVerifier(sig, backend="numpy")(pairs)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.all(got[:4] == 1.0)


def test_pair_counts_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.RandomState(12)
    sig = rng.randint(0, 2, size=(10, 7)).astype(np.uint32)
    a = _t(rng.randint(0, 10, size=50).astype(np.int64))
    b = _t(rng.randint(0, 10, size=50).astype(np.int64))
    k2.launches = 0
    assert torch.equal(k2.pair_counts(_t(sig), a, b),
                       k2.pair_counts_plain(_t(sig), a, b))
    assert k2.launches == 0
    with pytest.raises(TypeError):
        k2.pair_counts(_t(sig), a.int(), b)
