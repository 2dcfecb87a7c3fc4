"""Port parity of bounded retained state: ``core.retention``, the bounded
``BandIndex``, the verifiers' free-row pools, eviction sweeps and
``DedupSession.refine``.

Each session case runs ``repro_torch`` (``device="cpu"``, the kernels'
plain versions) and ``repro`` on the same seeded notes and chunks, and
holds labels, the (a, b, sim) list and the retention counters
(``evicted``, ``retained_rows``, ``filter_only_hits``, ``refine_merges``,
``representatives``, ``band_index.stats()``) equal bit for bit.  Mirrors
the host-backend cases of ``tests/test_retention.py``; its hypothesis
property is a parametrisation over fixed (seed, chunks, window) triples.
"""
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.session as ref_session
import repro.core.unionfind as ref_unionfind
import repro.core.verify as ref_verify
from repro.core.retention import BandBloomFilter as RefBloom
from repro.core.retention import _mix32 as ref_mix32
from repro.data import inject_near_duplicates, make_i2b2_like
from repro_torch.core import (
    BandBloomFilter,
    DedupConfig,
    DedupSession,
    RetentionManager,
    RetentionPolicy,
    shingle,
)
from repro_torch.core import sanitize
from repro_torch.core.engine import merge_cluster_rounds
from repro_torch.core.retention import _mix32_many
from repro_torch.core.session import BandIndex
from repro_torch.core.unionfind import ThresholdUnionFind
from repro_torch.core.verify import (
    CallbackVerifier,
    ExactJaccardVerifier,
    SignatureVerifier,
)


def _corpus(n=48, dups=32, seed=0):
    """Near-exact duplicate mass so unions (and evictions) happen."""
    notes = make_i2b2_like(n, seed=seed)
    notes, _ = inject_near_duplicates(notes, dups, frac_low=0.0,
                                      frac_high=0.005, seed=seed + 1)
    # Interleave so duplicates land in other chunks than their sources.
    rng = np.random.RandomState(seed + 2)
    order = rng.permutation(len(notes))
    return [notes[i] for i in order]


def _chunks(notes, k):
    return [[notes[i] for i in idx]
            for idx in np.array_split(np.arange(len(notes)), k)]


def _ref_policy(policy):
    """The reference's ``RetentionPolicy`` with the port policy's fields."""
    if policy is None:
        return None
    return ref_core.RetentionPolicy(
        lru_window=policy.lru_window, band_key_budget=policy.band_key_budget,
        bloom_bits=policy.bloom_bits, bloom_hashes=policy.bloom_hashes,
        refine_every=policy.refine_every)


def _sessions(policy=None, *, exact=False, backend="numpy",
              use_kernels=False, doc_id_base=0, **kw):
    """(port session, reference session) of the same config and policy.
    The reference verifies with numpy; the port's three estimate
    backends give numpy's bits, and ``use_kernels`` (K5 in refine) only
    changes where the port's fold runs."""
    cfg = {"exact_verification": exact, **kw}
    port = DedupSession(
        DedupConfig(verify_backend=backend, use_kernels=use_kernels, **cfg),
        retention=policy, doc_id_base=doc_id_base, device="cpu")
    ref = ref_session.DedupSession(
        ref_core.DedupConfig(store="memory", **cfg), backend="host",
        retention=_ref_policy(policy), doc_id_base=doc_id_base)
    return port, ref


def _assert_same_outcome(snap, ref_snap):
    """The reference test's ``_assert_same_session_outcome``."""
    np.testing.assert_array_equal(snap.labels, ref_snap.labels)
    assert snap.pairs == ref_snap.pairs   # bit-identical verified sims


def _assert_same(port, ref, snap, ref_snap):
    """Port against reference: outcome and every retention counter."""
    _assert_same_outcome(snap, ref_snap)
    for f in ("n_docs", "evicted", "retained_rows", "filter_only_hits",
              "refine_merges"):
        assert getattr(snap, f) == getattr(ref_snap, f), f
    if ref_snap.representatives is None:
        assert snap.representatives is None
    else:
        assert snap.representatives.tolist() == \
            ref_snap.representatives.tolist()
    assert port.band_index.stats() == ref.band_index.stats()
    assert port.refines_run == ref.refines_run


def _ingest_both(port, ref, chunks):
    for c in chunks:
        snap, ref_snap = port.ingest(c), ref.ingest(c)
        _assert_same(port, ref, snap, ref_snap)
    return snap, ref_snap


TIGHT = RetentionPolicy(lru_window=10, band_key_budget=None)


# -- eviction == append-only ------------------------------------------------

@pytest.mark.parametrize("exact", [True, False])
def test_host_evicted_session_matches_append_only(exact):
    notes = _corpus()
    chunks = _chunks(notes, 6)
    plain = DedupSession(DedupConfig(exact_verification=exact), device="cpu")
    for c in chunks:
        plain_snap = plain.ingest(c)
    port, ref = _sessions(TIGHT, exact=exact)
    snap, _ = _ingest_both(port, ref, chunks)
    _assert_same_outcome(snap, plain_snap)
    assert snap.evicted > 0, "budget never exercised eviction"
    assert snap.retained_rows == snap.n_docs - snap.evicted
    assert snap.filter_only_hits == 0      # no key budget: lossless
    roots = sorted({int(r) for r in snap.labels})
    assert snap.representatives.tolist() == roots


# The reference's hypothesis property (seed, n_chunks, window) at fixed
# draws: small and large windows, one chunk to six.  Chunk counts repeat,
# so the reference's jit compiles few chunk shapes.
@pytest.mark.parametrize("seed,n_chunks,window", [
    (0, 1, 1), (3, 6, 1), (17, 5, 40), (101, 5, 7), (512, 2, 13),
    (1023, 6, 25)])
def test_evicted_session_property(seed, n_chunks, window):
    notes = _corpus(30, 20, seed=seed)
    chunks = _chunks(notes, n_chunks)
    plain = DedupSession(DedupConfig(exact_verification=False), device="cpu")
    for c in chunks:
        plain.ingest(c)
    plain_snap = plain.refine()
    port, ref = _sessions(RetentionPolicy(lru_window=window))
    _ingest_both(port, ref, chunks)
    snap, ref_snap = port.refine(), ref.refine()
    _assert_same(port, ref, snap, ref_snap)
    _assert_same_outcome(snap, plain_snap)


def test_ingest_stream_with_retention_equals_sequential_ingest():
    """The lookahead dispatches chunk t + 1 before chunk t's sweep."""
    notes = _corpus(seed=5)
    chunks = _chunks(notes, 5)
    policy = RetentionPolicy(lru_window=6, band_key_budget=40,
                             refine_every=2)
    port, ref = _sessions(policy)
    for c, snap in zip(chunks, port.ingest_stream(chunks)):
        _assert_same(port, ref, snap, ref.ingest(c))
    assert snap.evicted > 0 and port.refines_run == 2


# -- bounded key budget ------------------------------------------------------

def test_key_budget_keeps_parity_for_recurring_duplicates():
    rng = np.random.RandomState(7)
    chunks, recent = [], []
    for t in range(6):
        fresh = make_i2b2_like(12, seed=100 + t)
        chunk = list(fresh)
        if recent:
            pool = [n for c in recent[-2:] for n in c]
            picks = rng.choice(len(pool), size=4)
            dup, _ = inject_near_duplicates(
                [pool[i] for i in picks], 4, frac_low=0.0,
                frac_high=0.005, seed=200 + t)
            chunk.extend(dup[4:])
        recent.append(fresh)
        chunks.append(chunk)
    plain = DedupSession(DedupConfig(exact_verification=False), device="cpu")
    for c in chunks:
        plain_snap = plain.ingest(c)
    port, ref = _sessions(RetentionPolicy(lru_window=40, band_key_budget=48))
    snap, _ = _ingest_both(port, ref, chunks)
    np.testing.assert_array_equal(snap.labels, plain_snap.labels)
    plain_sims = {(a, b): s for a, b, s in plain_snap.pairs}
    shared = [(a, b, s) for a, b, s in snap.pairs if (a, b) in plain_sims]
    assert shared and all(s == plain_sims[(a, b)] for a, b, s in shared)
    assert port.band_index.compacted_keys > 0, "budget never compacted a key"
    assert snap.evicted > 0


def test_key_budget_is_lru_hot_key_survives_churn():
    template = make_i2b2_like(1, seed=99)[0]
    chunks = []
    for t in range(10):
        dup, _ = inject_near_duplicates([template], 1, frac_low=0.0,
                                        frac_high=0.005, seed=300 + t)
        chunks.append(make_i2b2_like(12, seed=400 + t) + [dup[1]])
    plain = DedupSession(DedupConfig(exact_verification=False), device="cpu")
    for c in chunks:
        plain_snap = plain.ingest(c)
    port, ref = _sessions(RetentionPolicy(lru_window=30, band_key_budget=64))
    snap, _ = _ingest_both(port, ref, chunks)
    assert port.band_index.compacted_keys > 0   # churn exceeded the budget
    np.testing.assert_array_equal(snap.labels, plain_snap.labels)
    dup_ids = [13 * t + 12 for t in range(10)]
    assert len({int(snap.labels[i]) for i in dup_ids}) == 1


# -- BandIndex compaction and eviction units ---------------------------------

def test_band_index_evict_rewrites_onto_root():
    idx = BandIndex(1, track_entries=True)
    ref = ref_session.BandIndex(1, track_entries=True)
    b = np.array([[[1, 1]], [[1, 1]], [[2, 2]]], dtype=np.uint32)
    idx.match_then_insert(b, 0)
    ref.match_then_insert(b, 0)
    uf = ThresholdUnionFind(5, 0.3)
    uf.union(0, 1, 1.0)                       # 1 deposed under 0
    idx.evict([1], uf.find)
    ref.evict([1], uf.find)
    later = np.array([[[1, 1]]], dtype=np.uint32)
    edges = idx.match_then_insert(later, 3)
    assert sorted(map(tuple, edges.tolist())) == [(0, 3)]
    np.testing.assert_array_equal(edges, ref.match_then_insert(later, 3))
    assert idx.filter_only_hits == 0
    assert idx.export_maps() == ref.export_maps()
    assert idx._entries == ref._entries
    assert idx.stats() == ref.stats()
    with pytest.raises(ValueError, match="track_entries"):
        BandIndex(1).evict([0], uf.find)


def test_band_index_key_budget_compacts_into_bloom():
    idx = BandIndex(1, key_budget=2, track_entries=True)
    ref = ref_session.BandIndex(1, key_budget=2, track_entries=True)
    b = np.array([[[1, 1]], [[2, 2]], [[3, 3]]], dtype=np.uint32)
    for x in (idx, ref):
        x.match_then_insert(b, 0)             # 3 keys > budget 2
    assert idx.compacted_keys == 1            # oldest key (1, 1) compacted
    later = np.array([[[1, 1]]], dtype=np.uint32)
    edges = idx.match_then_insert(later, 3)
    ref.match_then_insert(later, 3)
    assert len(edges) == 0
    assert idx.filter_only_hits == 1
    kept = np.array([[[3, 3]]], dtype=np.uint32)
    edges = idx.match_then_insert(kept, 4)
    ref.match_then_insert(kept, 4)
    assert sorted(map(tuple, edges.tolist())) == [(2, 4)]
    st = idx.stats()
    assert st == ref.stats()
    assert st["compacted_keys"] == idx.compacted_keys
    assert st["bloom_bytes"] > 0
    got, want = idx.export_filters()[0], ref.export_filters()[0]
    np.testing.assert_array_equal(got._words, want._words)
    assert got.n_added == want.n_added
    assert got is not idx._filters[0]         # a frozen copy


def test_band_index_budget_matches_reference_over_chunks():
    """Many chunks, top-bit keys, a budget and evictions: edges, maps (in
    LRU order), filters and counters equal the reference's."""
    rng = np.random.RandomState(3)
    idx = BandIndex(3, key_budget=5, bloom_bits=1 << 10, track_entries=True)
    ref = ref_session.BandIndex(3, key_budget=5, bloom_bits=1 << 10,
                                track_entries=True)
    uf = ThresholdUnionFind(64, 0.0)
    base = 0
    for c in (6, 9, 7, 8, 5):
        bands = (rng.randint(0, 6, size=(c, 3, 2)).astype(np.uint32)
                 | np.uint32(0x80000000))
        np.testing.assert_array_equal(idx.match_then_insert(bands, base),
                                      ref.match_then_insert(bands, base))
        uf.union(base, base + 1, 1.0)
        gone = [d for d in range(base + 2) if uf.find(d) != d]
        idx.evict(gone[-1:], uf.find)
        ref.evict(gone[-1:], uf.find)
        base += c
    assert [list(m.items()) for m in idx.export_maps()] == \
        [list(m.items()) for m in ref.export_maps()]
    for got, want in zip(idx.export_filters(), ref.export_filters()):
        np.testing.assert_array_equal(got._words, want._words)
    assert idx.stats() == ref.stats() and idx.filter_only_hits > 0


def test_bloom_filter_membership():
    flt = BandBloomFilter(bits=1 << 12, num_hashes=4)
    ref = RefBloom(bits=1 << 12, num_hashes=4)
    rng = np.random.RandomState(0)
    added = rng.randint(0, 2**31, size=(100, 2))
    absent = rng.randint(2**31, 2**32, size=(100, 2), dtype=np.int64)
    keys = [(int(a), int(b)) for a, b in np.concatenate([added, absent])]
    for k in keys[:100]:
        flt.add(k)
        ref.add(k)
    np.testing.assert_array_equal(flt._words, ref._words)
    assert all(k in flt for k in keys[:100]), "no false negatives, ever"
    fp = sum(1 for k in keys[100:] if k in flt)
    assert fp < 30, f"false-positive rate implausibly high: {fp}/100"
    assert [k in flt for k in keys] == [k in ref for k in keys]
    # The batch forms: the same bits and the same answers.
    batch = BandBloomFilter(bits=1 << 12, num_hashes=4)
    batch.add_keys(np.array(keys[:100], dtype=np.uint32))
    np.testing.assert_array_equal(batch._words, ref._words)
    assert batch.n_added == ref.n_added == 100
    assert batch.contains_keys(np.array(keys, dtype=np.uint32)).tolist() == \
        [k in ref for k in keys]
    assert flt.memory_bytes == ref.memory_bytes
    cp = flt.copy()
    cp.add((7, 7))
    assert (7, 7) in cp and cp.n_added == flt.n_added + 1
    with pytest.raises(ValueError):
        BandBloomFilter(bits=1000)            # not a power of two
    # The batch hash against the reference's one-key hash, top bits
    # included.
    mixed = np.array(keys + [(2**32 - 1, 2**32 - 1)], dtype=np.uint32)
    for salt in range(4):
        want = [ref_mix32(int(a), int(b), salt) for a, b in mixed]
        assert _mix32_many(mixed, salt).tolist() == want


def test_retention_presets_match_reference():
    for name in RetentionPolicy.PRESETS:
        got = RetentionPolicy.preset(name, refine_every=3)
        want = ref_core.RetentionPolicy.preset(name, refine_every=3)
        assert _ref_policy(got) == want, name
    assert RetentionPolicy() == RetentionPolicy(lru_window=512)
    with pytest.raises(ValueError, match="unknown retention preset"):
        RetentionPolicy.preset("huge")
    assert RetentionManager(TIGHT).n_pending == 0


# -- verifier free-row pools -------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch", "kernel"])
def test_signature_verifier_free_slot_pool(backend):
    rng = np.random.RandomState(2)
    sig = rng.randint(0, 50, size=(12, 40)).astype(np.uint32)
    v = SignatureVerifier(sig[:8].copy(), backend=backend, device="cpu")
    ref = ref_verify.SignatureVerifier(sig)
    v(np.array([[0, 1]]))                     # make the device copy
    v.release_rows([1, 4, 6])
    assert v.n_live_rows == 5 and v.num_docs == 8
    caps = (len(v._host), None if v._dev is None else len(v._dev))
    v.extend_signatures(sig[8:11])            # docs 8..10 fill 3 slots
    assert (len(v._host), None if v._dev is None else len(v._dev)) == caps, \
        "free slots must be reused"
    v.extend_signatures(torch.from_numpy(sig[11:12].view(np.int32)))
    assert v.n_live_rows == 9 and v.num_docs == 12 and v._n_rows == 9
    live_pairs = np.array([(0, 8), (2, 9), (5, 10), (3, 11), (0, 2)],
                          dtype=np.int64)
    np.testing.assert_array_equal(v(live_pairs), ref(live_pairs))
    if v._dev is not None:                    # every copy got the rows
        np.testing.assert_array_equal(
            v._device_signatures().numpy().view(np.uint32), v.signatures)
    np.testing.assert_array_equal(v.rows_for([8, 11, 0]), sig[[8, 11, 0]])
    rows, slot_of = v.frozen_rows()
    assert set(slot_of) == {0, 2, 3, 5, 7, 8, 9, 10, 11}
    np.testing.assert_array_equal(rows[slot_of[9]], sig[9])
    v.release_rows([9])
    v.extend_signatures(sig[:1])              # rewrites doc 9's row
    np.testing.assert_array_equal(rows[slot_of[9]], sig[9])  # a copy
    with pytest.raises(KeyError, match="doc 4 has no retained signature"):
        v(np.array([[0, 4]]))                 # evicted doc
    with pytest.raises(KeyError):
        v.release_rows([4])                   # double release
    with pytest.raises(KeyError, match="doc 99 "):
        v(np.array([[0, 99]]))                # never allocated


def test_signature_verifier_slot_mapping_matches_reference():
    """Release, refill and release again: slot placement, the doc -> row
    map and sims equal the reference's at every step."""
    rng = np.random.RandomState(5)
    sig = rng.randint(0, 9, size=(40, 16)).astype(np.uint32)
    v = SignatureVerifier(sig[:10].copy(), backend="kernel", device="cpu")
    ref = ref_verify.SignatureVerifier(sig[:10].copy())
    n = 10
    for drop, add in (([2, 5, 7], 2), ([0, 1], 6), ([3, 8, 9, 10], 9)):
        v.release_rows(drop)
        ref.release_rows(drop)
        v.extend_signatures(sig[n : n + add])
        ref.extend_signatures(sig[n : n + add])
        n += add
        got_rows, got_map = v.frozen_rows()
        want_rows, want_map = ref.frozen_rows()
        assert got_map == want_map
        np.testing.assert_array_equal(got_rows, want_rows)
        live = sorted(got_map)
        pairs = np.array([(a, b) for a in live for b in live if a < b])
        np.testing.assert_array_equal(v(pairs), ref(pairs))


def test_signature_verifier_adopt_layout_shares_rows():
    rng = np.random.RandomState(6)
    sig = rng.randint(0, 9, size=(10, 16)).astype(np.uint32)
    owner = SignatureVerifier(sig[:6].copy(), backend="torch", device="cpu")
    owner.release_rows([1, 2])
    owner.extend_signatures(sig[6:])
    view = SignatureVerifier(np.zeros((0, 16), np.uint32), device="cpu")
    view.adopt_layout(owner)
    pairs = np.array([(0, 6), (7, 9), (3, 8)])
    np.testing.assert_array_equal(view(pairs), owner(pairs))
    assert view.n_live_rows == owner.n_live_rows == 8
    with pytest.raises(KeyError):
        view(np.array([[0, 1]]))


def test_exact_verifier_free_slot_pool():
    notes = _corpus(20, 10, seed=9)
    toks = [n.split() for n in notes]
    full = ExactJaccardVerifier.from_token_lists(toks, 8)
    v = ExactJaccardVerifier.from_token_lists(toks[:14], 8)
    ref = ref_verify.ExactJaccardVerifier.from_token_lists(toks[:14], 8)
    for x in (v, ref):
        x.release_rows([3, 7, 11])
    assert v.n_live_rows == 11
    rows_before = len(v._rows)
    for x in (v, ref):
        x.extend_token_lists(toks[14:17])     # docs 14..16 reuse slots
    assert len(v._rows) == rows_before
    for x in (v, ref):
        x.extend_token_lists(toks[17:])       # docs 17..29 append
    assert v.n_live_rows == len(toks) - 3
    pairs = np.array([(0, 14), (2, 16), (5, 19), (1, 2)], dtype=np.int64)
    np.testing.assert_array_equal(v(pairs), full(pairs))
    np.testing.assert_array_equal(v(pairs), ref(pairs))
    (ids, lengths, slot_of), want = v.frozen_rows(), ref.frozen_rows()
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(lengths, want[1])
    assert slot_of == want[2]
    with pytest.raises(KeyError, match="doc 7 has no retained token"):
        v(np.array([[0, 7]]))


def test_exact_verifier_slot_pool_survives_repad():
    toks = [[f"w{i}{j}" for j in range(6)] for i in range(6)]
    v = ExactJaccardVerifier.from_token_lists(toks, 2)
    ref_rows = list(toks)
    v.release_rows([1, 3])
    long_doc = [f"x{j}" for j in range(40)]   # forces lmax growth
    v.extend_token_lists([long_doc])          # doc 6 reuses a slot
    ref_rows.append(long_doc)
    ref = ExactJaccardVerifier.from_token_lists(ref_rows, 2)
    pairs = np.array([(0, 6), (2, 4), (5, 6)], dtype=np.int64)
    np.testing.assert_array_equal(v(pairs), ref(pairs))


# -- deposed-root tracking ---------------------------------------------------

def test_unionfind_deposed_tracking_and_drain():
    for uf in (ThresholdUnionFind(6, 0.3), ref_unionfind.ThresholdUnionFind(6, 0.3)):
        uf.track_deposed = True
        uf.union(0, 1, 1.0)
        uf.union(2, 3, 1.0)
        uf.union(0, 2, 1.0)
        drained = uf.drain_deposed()
        assert len(drained) == 3
        assert set(drained) == {i for i in range(6) if uf.find(i) != i}
        assert uf.drain_deposed() == []       # drained exactly once
        uf.union(4, 5, 1.0)
        assert len(uf.drain_deposed()) == 1
    uf2 = ThresholdUnionFind(4, 0.3)          # untracked unions log nothing
    uf2.union(0, 1, 1.0)
    assert uf2.drain_deposed() == []


# -- the second clustering round ---------------------------------------------

def _over_partitioned_uf():
    uf = ThresholdUnionFind(8, 0.3)
    for a, b in ((0, 1), (2, 3), (4, 5), (6, 7)):
        uf.union(a, b, 0.95)
    return uf


def test_merge_cluster_rounds_candidate_pairs_matches_full_sweep():
    sims = {(0, 2): 0.9, (4, 6): 0.85}

    def fn(a, b):
        return sims.get((min(a, b), max(a, b)), 0.5)

    uf_full = _over_partitioned_uf()
    m_full = merge_cluster_rounds(uf_full, fn, 0.75)
    uf_cand = _over_partitioned_uf()
    cand = np.array([(1, 3), (5, 7), (0, 4)], dtype=np.int64)
    m_cand = merge_cluster_rounds(uf_cand, fn, 0.75, candidate_pairs=cand)
    assert m_cand == m_full == 2
    np.testing.assert_array_equal(uf_full.components(), uf_cand.components())


def test_merge_cluster_rounds_shared_sim_cache_skips_dispatch():
    sims = {(0, 2): 0.9}

    def fn(a, b):
        return sims.get((min(a, b), max(a, b)), 0.5)

    uf = _over_partitioned_uf()
    cache = {(0, 2): 0.9, (0, 4): 0.5}        # verified by a session
    v = CallbackVerifier(fn)
    merges = merge_cluster_rounds(uf, v, 0.75, roots=[0, 2, 4, 6],
                                  sim_cache=cache, max_batch_pairs=2)
    assert merges == 1
    assert v.n_pairs == 2
    assert (0, 6) in cache and (4, 6) in cache  # results flow back


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_session_refine_merges_at_lower_threshold(backend):
    from dataclasses import replace

    rng = np.random.RandomState(4)
    vocab = [f"t{i}" for i in range(120)]
    base_doc = list(rng.choice(vocab, size=60))
    near = list(base_doc)
    near[30] = "zz"         # one changed token: 8-gram Jaccard ~0.74
    docs = [" ".join(base_doc), " ".join(base_doc),
            " ".join(near), " ".join(near)]
    port, ref = _sessions(exact=False, backend=backend, edge_threshold=0.9,
                          tree_threshold=0.1,
                          use_kernels=backend == "kernel")
    snap = port.ingest(docs)
    _assert_same(port, ref, snap, ref.ingest(docs))
    assert snap.labels[0] == snap.labels[1]
    assert snap.labels[2] == snap.labels[3]
    assert snap.labels[0] != snap.labels[2]   # over-partitioned
    port.config = replace(port.config, edge_threshold=0.45)
    ref.config = replace(ref.config, edge_threshold=0.45)
    snap = port.refine()
    _assert_same(port, ref, snap, ref.refine())
    assert snap.refine_merges >= 1
    assert snap.labels[0] == snap.labels[2]
    assert port.stage_timings["refine_pairs"] > 0


def test_refine_ignores_doc_id_base_gap_singletons():
    notes = _corpus(20, 10, seed=19)
    base = 7
    port, ref = _sessions(doc_id_base=base)
    port.ingest(notes)
    ref.ingest(notes)
    snap = port.refine()
    _assert_same(port, ref, snap, ref.refine())
    assert (snap.labels[:base] == np.arange(base)).all(), \
        "gap singletons must survive refine()"
    assert all(a >= base and b >= base for a, b, _ in snap.pairs)


def test_refine_of_an_exact_session_sweeps_representatives():
    """Exact sessions have no signature rows: refine sweeps every
    representative pair, through the exact verifier."""
    notes = _corpus(24, 10, seed=29)
    port, ref = _sessions(RetentionPolicy(lru_window=4), exact=True)
    _ingest_both(port, ref, _chunks(notes, 3))
    snap = port.refine()
    _assert_same(port, ref, snap, ref.refine())
    assert port.stage_timings["refine_pairs"] == 0


def test_retention_preset_none_tracks_roots_without_evicting():
    notes = _corpus(24, 16, seed=23)
    port, ref = _sessions(RetentionPolicy.preset("none", refine_every=2))
    snap, _ = _ingest_both(port, ref, _chunks(notes, 4))
    assert port.refines_run == 2
    assert snap.evicted == 0
    assert snap.retained_rows == snap.n_docs
    assert snap.stats.unions_done > 0       # dups clustered...
    assert port.retention.n_pending == 0    # ...but nothing queued
    roots = sorted({int(r) for r in snap.labels})
    assert snap.representatives.tolist() == roots


def test_session_refine_auto_trigger_cadence():
    notes = _corpus(24, 12, seed=11)
    port, ref = _sessions(RetentionPolicy(lru_window=8, refine_every=2),
                          backend="torch")
    _ingest_both(port, ref, _chunks(notes, 4))
    assert port.refines_run == 2              # steps 2 and 4


def test_view_of_an_evicted_session_copies_rows_and_filters():
    """The eviction layout's view: rows and map copied at publication,
    filters frozen, and the publication key covers evictions,
    compaction and refines."""
    notes = _corpus(40, 30, seed=31)
    policy = RetentionPolicy(lru_window=6, band_key_budget=30,
                             bloom_bits=1 << 12)
    sess, ref = _sessions(policy)
    chunks = _chunks(notes, 5)
    _ingest_both(sess, ref, chunks[:4])
    view = sess.view()
    assert view.slot_of is not None and len(view.slot_of) == \
        sess.verifier.n_live_rows
    assert any(f is not None for f in view.band_filters)
    frozen = view.signatures.copy()
    frozen_words = [f._words.copy() if f is not None else None
                    for f in view.band_filters]
    _ingest_both(sess, ref, chunks[4:])
    np.testing.assert_array_equal(view.signatures, frozen)
    for f, w in zip(view.band_filters, frozen_words):
        assert (f is None) == (w is None)
        if f is not None:
            np.testing.assert_array_equal(f._words, w)
    v2 = sess.view()
    assert v2 is not view and v2.version == view.version + 1
    sess.refine()
    assert sess.view() is not v2


@pytest.mark.parametrize("exact", [False, True])
def test_view_published_before_the_first_eviction_keeps_its_rows(exact):
    """A view frozen in the append-only layout shares the verifier's row
    buffers.  The first eviction gives the verifier buffers of its own,
    so the evicting sweep and the later extensions into freed rows leave
    that view's arrays as they were.  The chunks stay inside the buffers'
    capacity after the view, so no regrowth hides a write."""
    base = make_i2b2_like(52, seed=3)
    dups = inject_near_duplicates(base[:40], 4, frac_low=0.0,
                                  frac_high=0.005, seed=4)[0][40:]
    sess = DedupSession(DedupConfig(exact_verification=exact),
                        retention=RetentionPolicy(lru_window=4,
                                                  band_key_budget=None),
                        device="cpu")
    sess.ingest(base[:40])
    sess.ingest(base[40:44])
    snap = sess.ingest(dups)         # deposes docs the view will hold
    assert snap.evicted == 0 and len(snap.representatives) < snap.n_docs
    view = sess.view()
    fingerprint = sanitize.view_fingerprint(view)
    for chunk in (base[44:48], base[48:52]):
        snap = sess.ingest(chunk)
    assert snap.evicted > 0
    assert sess.verifier._n_rows < sess.n_docs, "no freed row reused"
    assert sanitize.view_fingerprint(view) == fingerprint


# -- tokenized ingest --------------------------------------------------------

def test_ingest_stream_tokenized_never_retokenizes(monkeypatch):
    notes = _corpus(24, 12, seed=13)
    port, ref = _sessions(exact=True)
    for c in _chunks(notes, 3):
        ref_snap = ref.ingest(c)
    toks = [shingle.tokenize(t) for t in notes]
    tok_chunks = [[toks[i] for i in idx]
                  for idx in np.array_split(np.arange(len(notes)), 3)]

    def boom(text, do_stem=True):
        raise AssertionError("tokenize called on pre-tokenized ingest")

    monkeypatch.setattr(shingle, "tokenize", boom)
    for snap in port.ingest_stream(tok_chunks, tokenized=True):
        pass
    np.testing.assert_array_equal(snap.labels, ref_snap.labels)
    assert snap.pairs == ref_snap.pairs
