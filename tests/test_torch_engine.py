"""Port parity for the engine: candidates, verifiers, union-find, clustering."""
import numpy as np
import pytest
import torch

from repro.core import candidates as ref_cand
from repro.core import cluster as ref_cluster
from repro.core import engine as ref_engine
from repro.core import shingle as ref_shingle
from repro.core import unionfind as ref_uf
from repro.core import verify as ref_verify
from repro.data import inject_near_duplicates, make_i2b2_like
from repro_torch.core import candidates, cluster, engine, unionfind, verify


def _bands(D=60, b=6, distinct=5, seed=0):
    """Low-entropy band values so that runs of several docs occur."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, distinct, size=(D, b, 2)).astype(np.uint32)


def _corpus():
    notes, _ = inject_near_duplicates(make_i2b2_like(30, seed=5), 20,
                                      frac_high=0.1, seed=6)
    toks = [ref_shingle.tokenize(t) for t in notes]
    packed = ref_shingle.pack_documents(toks)
    ng, valid = ref_shingle.ngram_hashes_np(packed.tokens, packed.lengths)
    from repro.core.minhash import signatures_np, default_seeds
    from repro.core.lsh import band_values_np

    sig = signatures_np(ng, valid, default_seeds(100))
    return toks, sig, band_values_np(sig, 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_band_matrix_source_runs_match_reference(seed):
    bands = _bands(seed=seed)
    for base in (0, 2**31 + 5):
        got = list(candidates.BandMatrixSource(bands, base).iter_bands())
        want = list(ref_cand.BandMatrixSource(bands, base).iter_bands())
        assert len(got) == len(want) == bands.shape[1]
        for g, w in zip(got, want):
            assert g.band_id == w.band_id
            for f in ("sorted_vals", "sorted_docs", "run_starts", "run_ends"):
                assert np.array_equal(getattr(g, f), getattr(w, f)), f
            assert g.sorted_docs.dtype == np.int64
            assert [list(x) for x in g.iter_groups()] == \
                [list(x) for x in w.iter_groups()]


def test_candidate_pairs_match_reference_with_int64_ids():
    bands = _bands(seed=2)
    src = candidates.BandMatrixSource(bands, doc_id_base=2**32)
    got = candidates.candidate_pairs(src)
    want = ref_cand.candidate_pairs(ref_cand.BandMatrixSource(bands, 2**32))
    assert got.dtype == np.int64 and np.array_equal(got, want)
    br = next(iter(src.iter_bands()))
    for cap in (None, 3):
        assert np.array_equal(
            candidates.pairs_in_runs(br.sorted_vals, br.sorted_docs, cap),
            ref_cand.pairs_in_runs(br.sorted_vals, br.sorted_docs, cap))
    assert isinstance(src, candidates.CandidateSource)


def test_threshold_union_find_matches_reference():
    rng = np.random.RandomState(3)
    got = unionfind.ThresholdUnionFind(50, 0.4)
    want = ref_uf.ThresholdUnionFind(50, 0.4)
    got.track_deposed = want.track_deposed = True
    for _ in range(200):
        x, y = rng.randint(0, 50, size=2)
        s = float(rng.uniform(0.5, 1.0))
        assert got.union(int(x), int(y), s) == want.union(int(x), int(y), s)
    got.grow(60)
    want.grow(60)
    assert np.array_equal(got.components(), want.components())
    assert got.clusters() == want.clusters()
    assert np.array_equal(got.min_score, want.min_score)
    assert (got.n_unions, got.n_rejected) == (want.n_unions, want.n_rejected)
    assert got.drain_deposed() == want.drain_deposed()


def test_exact_verifier_matches_reference():
    toks, _, _ = _corpus()
    toks = toks + [[], ["a", "b"], []]
    rng = np.random.RandomState(4)
    pairs = rng.randint(0, len(toks), size=(500, 2))
    pairs[0] = [len(toks) - 1, len(toks) - 3]  # two empty documents
    got = verify.ExactJaccardVerifier.from_token_lists(toks, 8, 64)(pairs)
    want = ref_verify.ExactJaccardVerifier.from_token_lists(toks, 8)(pairs)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("backend", ["numpy", "torch", "kernel"])
def test_signature_verifier_backends_are_the_numpy_estimator(backend):
    _, sig, _ = _corpus()
    rng = np.random.RandomState(7)
    pairs = rng.randint(0, len(sig), size=(3000, 2))
    v = verify.SignatureVerifier(sig, backend=backend, batch_pairs=1000,
                                 device="cpu")
    got = v(pairs)
    want = ref_verify.SignatureVerifier(sig, backend="numpy")(pairs)
    assert np.array_equal(got, want)
    assert (v.n_batches, v.n_pairs) == (3, 3000)
    tv = verify.SignatureVerifier(torch.from_numpy(sig.view(np.int32)),
                                  backend=backend, device="cpu")
    assert np.array_equal(tv(pairs), want)
    assert np.array_equal(tv.signatures, sig)
    with pytest.raises(IndexError):
        v(np.array([[0, len(sig)]]))


def test_verifier_checks_backend_and_device():
    with pytest.raises(ValueError):
        verify.SignatureVerifier(np.zeros((2, 4), np.uint32), backend="jnp",
                                 device="cpu")
    with pytest.raises(RuntimeError):
        verify.SignatureVerifier(np.zeros((2, 4), np.uint32),
                                 backend="kernel")
    assert isinstance(verify.as_verifier(lambda a, b: 1.0),
                      verify.CallbackVerifier)
    with pytest.raises(TypeError):
        verify.as_verifier(3)


@pytest.mark.parametrize("batch", ["run", "band"])
@pytest.mark.parametrize("disjoint", [True, False])
def test_cluster_source_matches_reference(batch, disjoint):
    _, sig, bands = _corpus()
    got_uf, got_stats, got_pairs = engine.cluster_source(
        candidates.BandMatrixSource(bands),
        verify.SignatureVerifier(sig, device="cpu"), 0.5, 0.3,
        use_disjoint_sets=disjoint, batch=batch)
    want_uf, want_stats, want_pairs = ref_engine.cluster_source(
        ref_cand.BandMatrixSource(bands),
        ref_verify.SignatureVerifier(sig), 0.5, 0.3,
        use_disjoint_sets=disjoint, batch=batch)
    assert np.array_equal(got_uf.components(), want_uf.components())
    assert got_pairs == want_pairs
    for f in ("pairs_generated", "pairs_evaluated", "pairs_excluded",
              "pairs_above_edge", "unions_done", "unions_rejected",
              "verify_batches"):
        assert getattr(got_stats, f) == getattr(want_stats, f), f


def test_cluster_bands_and_merge_rounds_match_reference():
    _, sig, bands = _corpus()
    got = cluster.cluster_bands(bands, verify.SignatureVerifier(
        sig, device="cpu"), 0.75, 0.4)
    want = ref_cluster.cluster_bands(bands, ref_verify.SignatureVerifier(sig),
                                     0.75, 0.4)
    assert np.array_equal(got[0].components(), want[0].components())
    assert got[2] == want[2]
    got_m = engine.merge_cluster_rounds(
        got[0], verify.SignatureVerifier(sig, device="cpu"), 0.3,
        max_batch_pairs=64)
    want_m = ref_engine.merge_cluster_rounds(
        want[0], ref_verify.SignatureVerifier(sig), 0.3, max_batch_pairs=64)
    assert got_m == want_m
    labels = got[0].components()
    assert np.array_equal(labels, want[0].components())
    assert cluster.modularity(labels, got[2]) == \
        ref_cluster.modularity(labels, want[2])


def test_accumulator_shares_its_cache_across_feeds():
    _, sig, bands = _corpus()
    got = engine.ClusterAccumulator(
        len(sig), verify.SignatureVerifier(sig, device="cpu"), 0.5, 0.3)
    want = ref_engine.ClusterAccumulator(
        len(sig), ref_verify.SignatureVerifier(sig), 0.5, 0.3)
    for acc, mod in ((got, candidates), (want, ref_cand)):
        acc.feed(mod.BandMatrixSource(bands[:, :25]))
        second = acc.feed(mod.BandMatrixSource(bands))
        assert second.pairs_excluded > 0
    assert got.pairs == want.pairs
    assert got.stats.pairs_evaluated == want.stats.pairs_evaluated
    with pytest.raises(ValueError):
        engine.ClusterAccumulator(3, got.verifier, 0.5, 0.3, batch="doc")
