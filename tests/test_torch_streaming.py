"""Port parity of the streaming backend and the memory-tier band stores.

Each case runs ``repro_torch`` (``device="cpu"``, the kernels' plain
versions) and ``repro`` on the same seeded notes and holds labels, the
(a, b, sim) list, the ``ClusterStats`` counters and the stores' rows
equal bit for bit.  Mirrors the streaming cases of
``tests/test_session.py``, ``test_retention.py``, ``test_byte_ingest.py``
and ``test_query_service.py``, the dedup half of
``test_streaming_serving.py``, the store and streaming cases of
``test_staged_engine.py`` and the memory-tier half of
``test_bandstore_backends.py``; a store file written by either package
reads the same through the other.
"""
import dataclasses
import sqlite3

import numpy as np
import pytest

import repro.core.bandstore as ref_bandstore
import repro.core.candidates as ref_candidates
import repro.core.pipeline as ref_pipeline
import repro.core.session as ref_session
import repro.core.streaming as ref_streaming
import repro.core.unionfind as ref_unionfind
from repro.core.retention import RetentionPolicy as RefPolicy
from repro.data import inject_near_duplicates, make_i2b2_like
from repro_torch.core import (
    DedupConfig,
    DedupPipeline,
    DedupSession,
    RetentionPolicy,
    StoreBandSource,
    shingle,
)
from repro_torch.core.bandstore import (
    STORE_KINDS,
    BandStoreBackend,
    Design1Store,
    Design2Store,
    SqliteBandStore,
    _decode_part,
    _encode_part_v2,
    make_store,
)
from repro_torch.core.candidates import BandMatrixSource, candidate_pairs
from repro_torch.core.streaming import StreamingDedup, merge_cluster_rounds
from repro_torch.core.unionfind import ThresholdUnionFind
from repro_torch.core.verify import SignatureVerifier

# ClusterStats counters (verify_seconds is a wall time).
COUNTERS = ("pairs_generated", "pairs_evaluated", "pairs_excluded",
            "pairs_above_edge", "unions_done", "unions_rejected",
            "verify_batches")


def _corpus(n=60, dups=40, seed=0):
    notes = make_i2b2_like(n, seed=seed)
    notes, _ = inject_near_duplicates(notes, dups, seed=seed + 1)
    return notes


def _dup_corpus(n=48, dups=32, seed=0):
    """Near-exact duplicate mass, interleaved, so unions and evictions
    happen across chunks."""
    notes = make_i2b2_like(n, seed=seed)
    notes, _ = inject_near_duplicates(notes, dups, frac_low=0.0,
                                      frac_high=0.005, seed=seed + 1)
    order = np.random.RandomState(seed + 2).permutation(len(notes))
    return [notes[i] for i in order]


def _chunks(notes, k):
    return [[notes[i] for i in idx]
            for idx in np.array_split(np.arange(len(notes)), k)]


def _configs(**fields):
    """(reference DedupConfig, the port's) of the same fields, memory tier."""
    return (ref_pipeline.DedupConfig(store="memory", **fields),
            DedupConfig(store="memory", **fields))


def _assert_same(got, want):
    assert got.n_docs == want.n_docs
    np.testing.assert_array_equal(got.labels, want.labels)
    for f in COUNTERS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.pairs == want.pairs
    assert got.retained_rows == want.retained_rows
    assert got.evicted == want.evicted


def _canon(labels):
    first = {}
    return [first.setdefault(int(r), i) for i, r in enumerate(labels)]


def _both_streaming(ref_cfg, cfg, chunks, **kw):
    """Reference and port streaming sessions fed ``chunks`` one ``ingest``
    at a time, held equal after every chunk."""
    ref_kw = dict(kw)
    if "retention" in kw:
        ref_kw["retention"] = RefPolicy(**dataclasses.asdict(kw["retention"]))
    ref = ref_session.DedupSession(ref_cfg, backend="streaming", **ref_kw)
    port = DedupSession(cfg, backend="streaming", device="cpu", **kw)
    for chunk in chunks:
        want = ref.ingest(chunk)
        got = port.ingest(chunk)
        _assert_same(got, want)
    return port, ref, got, want


def _store_rows(store, num_bands):
    return [tuple(a.tolist() for a in store.read_band(j))
            for j in range(num_bands)]


# -- the streaming session (test_session.py) ----------------------------------

@pytest.mark.parametrize("n_chunks", [1, 3])
def test_streaming_session_matches_reference_and_one_shot(n_chunks):
    notes = _corpus()
    ref_cfg, cfg = _configs(exact_verification=False)
    port, ref, snap, _ = _both_streaming(ref_cfg, cfg, _chunks(notes, n_chunks),
                                         chunk_docs=16)
    one = DedupPipeline(cfg, device="cpu").run(notes)
    np.testing.assert_array_equal(snap.labels, one.labels)
    sims = {(a, b): s for a, b, s in one.pairs}
    shared = [(s, sims[(a, b)]) for a, b, s in snap.pairs if (a, b) in sims]
    assert shared and all(x == y for x, y in shared)
    # The store re-scan's sim cache never verifies a pair twice.
    assert snap.stats.pairs_evaluated <= (one.stats.pairs_evaluated
                                          + snap.stats.pairs_above_edge)
    sd, ref_sd = port._impl.sd, ref._impl.sd
    assert sd.store.n_entries() == ref_sd.store.n_entries()
    assert (sd.store.n_writes, sd.store.write_bytes) == (
        ref_sd.store.n_writes, ref_sd.store.write_bytes)
    assert _store_rows(sd.store, cfg.num_bands) == _store_rows(
        ref_sd.store, cfg.num_bands)


def test_streaming_session_kernel_backend_and_lookahead_match_reference():
    """``ingest_stream`` (chunk t+1 dispatched before chunk t merges) with
    fused ingest and the kernel verify backend (K1's and K2's plain
    versions here) equals the reference's staged, numpy-verified run."""
    notes = _dup_corpus(seed=5)
    ref_cfg = ref_pipeline.DedupConfig(store="memory", exact_verification=False,
                                       verify_batch="band")
    cfg = DedupConfig(store="memory", exact_verification=False,
                      verify_batch="band", fused_ingest=True,
                      use_kernels=True, verify_backend="kernel")
    ref = ref_session.DedupSession(ref_cfg, backend="streaming", chunk_docs=8)
    port = DedupSession(cfg, backend="streaming", chunk_docs=8, device="cpu")
    chunks = _chunks(notes, 4)
    for got, want in zip(port.ingest_stream(chunks),
                         ref.ingest_stream(chunks)):
        _assert_same(got, want)
    assert port._impl.sd.n_docs == len(notes)
    assert isinstance(port.verifier, SignatureVerifier)
    assert port.verifier.backend == "kernel"
    assert set(port.stage_timings) >= {"phase1_s", "rescan_s", "engine_s",
                                       "merge_s", "phase1_kernel_s",
                                       "phase1_store_s"}


def test_streaming_cluster_adapter_session_stays_live():
    """``StreamingDedup.cluster`` equals the ``over_store`` snapshot, the
    reference's too, and the adopted session keeps taking chunks."""
    notes = _corpus(40, 20, seed=7)
    ref_cfg, cfg = _configs()
    sd = StreamingDedup(cfg, chunk_docs=8, device="cpu")
    ref_sd = ref_streaming.StreamingDedup(ref_cfg, chunk_docs=8)
    sd.ingest(notes)
    ref_sd.ingest(notes)
    uf, stats = sd.cluster()
    ref_uf, ref_stats = ref_sd.cluster()
    np.testing.assert_array_equal(uf.components(), ref_uf.components())
    assert {k: v for k, v in stats.items() if k != "verify_seconds"} == \
        {k: v for k, v in ref_stats.items() if k != "verify_seconds"}
    sess = DedupSession.over_store(sd)
    ref_sess = ref_session.DedupSession.over_store(ref_sd)
    np.testing.assert_array_equal(uf.components(), sess.uf.components())
    _assert_same(sess.snapshot(), ref_sess.snapshot())
    # A duplicate of doc 0 ingested later joins doc 0's cluster.
    snap = sess.ingest([notes[0]])
    _assert_same(snap, ref_sess.ingest([notes[0]]))
    assert snap.n_docs == len(notes) + 1
    assert snap.labels[len(notes)] == snap.labels[0]


# -- retention over the store (test_retention.py, test_bandstore_backends.py) -

def test_streaming_evicted_session_matches_append_only():
    notes = _dup_corpus(seed=3)
    ref_cfg, cfg = _configs(exact_verification=False)
    chunks = _chunks(notes, 5)
    plain, _, ref_snap, _ = _both_streaming(ref_cfg, cfg, chunks, chunk_docs=16)
    sess, ref, snap, want = _both_streaming(
        ref_cfg, cfg, chunks, chunk_docs=16,
        retention=RetentionPolicy(lru_window=10, band_key_budget=None))
    np.testing.assert_array_equal(snap.labels, ref_snap.labels)
    assert snap.pairs == ref_snap.pairs
    assert snap.evicted > 0
    assert snap.representatives.tolist() == want.representatives.tolist()
    assert sess._impl.sd.store.n_entries() == ref._impl.sd.store.n_entries()


def test_streaming_session_stores_signatures_once():
    notes = _corpus(30, 15, seed=17)
    ref_cfg, cfg = _configs(exact_verification=False)
    sess, _, snap, _ = _both_streaming(ref_cfg, cfg, _chunks(notes, 3),
                                       chunk_docs=8)
    # The session verifier owns the rows; the phase-1 cache keeps none.
    assert len(sess._impl.sd._sig_cache) == 0
    assert sess._impl.sd.n_docs == len(notes)
    one = DedupPipeline(cfg, device="cpu").run(notes)
    assert _canon(snap.labels) == _canon(one.labels)
    np.testing.assert_array_equal(sess.signatures, one.signatures)


def test_streaming_store_compaction_bounds_row_count():
    """The streaming store rewrites evicted docs' rows onto their roots,
    so the compacted store holds strictly fewer entries than the
    append-only one, in both packages alike."""
    chunks = _chunks(_dup_corpus(seed=11), 5)
    ref_cfg, cfg = _configs(exact_verification=False)
    plain, ref_plain, pl_snap, _ = _both_streaming(ref_cfg, cfg, chunks,
                                                   chunk_docs=16)
    sess, ref, snap, _ = _both_streaming(
        ref_cfg, cfg, chunks, chunk_docs=16,
        retention=RetentionPolicy(lru_window=10))
    np.testing.assert_array_equal(snap.labels, pl_snap.labels)
    assert snap.pairs == pl_snap.pairs
    assert snap.evicted > 0
    n_plain = plain._impl.sd.store.n_entries()
    n_kept = sess._impl.sd.store.n_entries()
    assert n_kept < n_plain
    assert (n_plain, n_kept) == (ref_plain._impl.sd.store.n_entries(),
                                 ref._impl.sd.store.n_entries())
    assert _store_rows(sess._impl.sd.store, cfg.num_bands) == _store_rows(
        ref._impl.sd.store, cfg.num_bands)


def test_design2_compact_preserves_scan_order():
    """In-place root rewrite and keep-first dedup, as the reference's."""
    rng = np.random.default_rng(3)
    bands = rng.integers(0, 4, size=(10, 2, 2), dtype=np.uint32)
    stores = [Design2Store(part_size=3), ref_bandstore.Design2Store(part_size=3)]
    for store in stores:
        for d in range(10):
            store.insert_document(d, bands[d])
        store.commit()
    uf = ThresholdUnionFind(10, 0.3)
    uf.union(0, 7, 1.0)
    uf.union(2, 9, 1.0)
    evicted = [d for d in range(10) if uf.find(d) != d]
    for store in stores:
        store.compact(evicted, uf.find)
    got, want = stores
    assert _store_rows(got, 2) == _store_rows(want, 2)
    for j in range(2):
        docs, vals = got.read_band(j)
        assert not np.isin(docs, evicted).any()
        seen = list(zip(map(tuple, vals.tolist()), docs.tolist()))
        assert len(seen) == len(set(seen))
    # Parts are rewritten from 0; later flushes still sort after them.
    assert got._next_part == want._next_part
    for store in stores:
        store.insert_document(10, bands[0])
        store.commit()
    assert _store_rows(got, 2) == _store_rows(want, 2)


# -- byte ingest and the read path --------------------------------------------

def test_streaming_byte_session_matches_token_session():
    """A byte streaming session (K6 and K1's plain versions) equals a
    token streaming session fed no-stem token lists, and that equals the
    reference's token streaming session."""
    notes = make_i2b2_like(40, seed=0)
    notes, _ = inject_near_duplicates(notes, 8, frac_low=0.0,
                                      frac_high=0.005, seed=1)
    kw = dict(exact_verification=False, edge_threshold=0.88)
    ref_cfg, tok_cfg = _configs(**kw)
    tok = DedupSession(tok_cfg, backend="streaming", device="cpu")
    byt = DedupSession(DedupConfig(byte_ingest=True, store="memory", **kw),
                       backend="streaming", device="cpu")
    ref = ref_session.DedupSession(ref_cfg, backend="streaming")
    for lo in range(0, len(notes), 16):
        chunk = notes[lo:lo + 16]
        toks = [shingle.tokenize(t, do_stem=False) for t in chunk]
        snap_t = tok.ingest_tokens(toks)
        snap_b = byt.ingest(chunk)
        want = ref.ingest_tokens(toks)
    assert snap_b.labels.tolist() == snap_t.labels.tolist()
    assert snap_b.pairs == snap_t.pairs
    _assert_same(snap_t, want)
    _, counts = np.unique(snap_b.labels, return_counts=True)
    assert (counts >= 2).sum() > 0


def test_streaming_backend_has_no_view():
    sess = DedupSession(DedupConfig(store="memory"), backend="streaming",
                        device="cpu")
    sess.ingest(_corpus(10, 5))
    with pytest.raises(ValueError, match="band store"):
        sess.view()


# -- StreamingDedup (test_streaming_serving.py) -------------------------------

def test_streaming_matches_batch_pipeline():
    notes = make_i2b2_like(80, seed=0)
    notes = notes + [notes[0]] * 3 + [notes[5]] * 2
    ref_cfg, cfg = _configs()
    batch = DedupPipeline(cfg, device="cpu").run(notes)
    sd = StreamingDedup(cfg, chunk_docs=16, device="cpu")
    sd.ingest(notes)
    assert sd.n_docs == len(notes)
    uf, stats = sd.cluster()
    ref_sd = ref_streaming.StreamingDedup(ref_cfg, chunk_docs=16)
    ref_sd.ingest(notes)
    ref_uf, ref_stats = ref_sd.cluster()
    sl = uf.components()
    np.testing.assert_array_equal(sl, ref_uf.components())
    assert stats["pairs_evaluated"] == ref_stats["pairs_evaluated"]
    assert (sl[80] == sl[0]) and (sl[81] == sl[0]) and (sl[82] == sl[0])
    assert (sl[83] == sl[5]) and (sl[84] == sl[5])
    assert len(notes) - len(set(sl.tolist())) == batch.num_duplicates_removed


def test_streaming_incremental_ingest_and_rethreshold():
    notes = make_i2b2_like(40, seed=1)
    ref_cfg, cfg = _configs()
    sd = StreamingDedup(cfg, chunk_docs=8, device="cpu")
    ref_sd = ref_streaming.StreamingDedup(ref_cfg, chunk_docs=8)
    for s in (sd, ref_sd):
        s.ingest(notes)
        s.ingest([notes[3], notes[7]])   # late-arriving duplicates
    n0 = len(notes)
    assert sd.n_docs == n0 + 2
    uf, _ = sd.cluster()
    labels = uf.components()
    np.testing.assert_array_equal(labels, ref_sd.cluster()[0].components())
    assert labels[n0] == labels[3]
    assert labels[n0 + 1] == labels[7]
    # Phase 2 again at another threshold, without re-hashing.
    uf2, st2 = sd.cluster(edge_threshold=0.95)
    ref_uf2, ref_st2 = ref_sd.cluster(edge_threshold=0.95)
    np.testing.assert_array_equal(uf2.components(), ref_uf2.components())
    assert st2["pairs_evaluated"] == ref_st2["pairs_evaluated"]
    assert len(set(uf2.components().tolist())) >= len(set(labels.tolist()))


def test_second_round_merging():
    """Paper §10: a second round merges over-partitioned clusters."""
    sims = {(a, b): 0.9 for a in range(4) for b in range(4) if a < b}
    sim = lambda a, b: sims[(min(a, b), max(a, b))]   # noqa: E731
    out = []
    for uf_cls, merge in ((ThresholdUnionFind, merge_cluster_rounds),
                          (ref_unionfind.ThresholdUnionFind,
                           ref_streaming.merge_cluster_rounds)):
        uf = uf_cls(4, tree_threshold=0.4)
        uf.union(0, 1, 0.9)
        uf.union(2, 3, 0.9)
        assert uf.find(0) != uf.find(2)
        out.append((merge(uf, sim, edge_threshold=0.75),
                    uf.components().tolist()))
    assert out[0] == out[1]
    assert out[0][0] == 1 and out[0][1][0] == out[0][1][2]


# -- the candidate layer and the stores (test_staged_engine.py) ---------------

def test_three_candidate_sources_identical_pairs():
    notes = _corpus()
    ref_cfg, cfg = _configs()
    pipe = DedupPipeline(cfg, device="cpu")
    sig = pipe.compute_signatures(pipe.tokenize(notes))
    bands = pipe.compute_bands(sig)
    d, b, _ = bands.shape
    mem_pairs = candidate_pairs(BandMatrixSource(bands))
    assert len(mem_pairs)
    s1, s2 = Design1Store(), Design2Store(part_size=16)
    for i in range(d):
        s1.insert_document(i, bands[i])
        s2.insert_document(i, bands[i])
    s1.commit()
    s2.commit()
    sd = StreamingDedup(cfg, chunk_docs=16, device="cpu")
    sd.ingest(notes)
    ref_sd = ref_streaming.StreamingDedup(ref_cfg, chunk_docs=16)
    ref_sd.ingest(notes)
    want = ref_candidates.candidate_pairs(ref_sd.candidate_source())
    for source in (StoreBandSource(s1, b, d), StoreBandSource(s2, b, d),
                   sd.candidate_source()):
        got = candidate_pairs(source)
        np.testing.assert_array_equal(got, mem_pairs)
        np.testing.assert_array_equal(got, want)
    assert sd.candidate_source().scan_s == 0.0


def test_streaming_cluster_uses_batched_verifier():
    notes = _corpus(40, 20, seed=3)
    sd = StreamingDedup(DedupConfig(store="memory"), chunk_docs=8,
                        device="cpu")
    sd.ingest(notes)
    uf_b, stats = sd.cluster()
    assert stats["verify_batches"] >= 1
    row = sd._sig_cache.__getitem__
    uf_s, _ = sd.cluster(similarity_fn=lambda a, b: float(
        (row(a) == row(b)).mean()))
    np.testing.assert_array_equal(uf_b.components(), uf_s.components())


def test_design2_store_noncontiguous_doc_ids_round_trip():
    rng = np.random.RandomState(0)
    ids = [3, 100, 2**31 + 7, 11, 2**31 + 5]
    bands = {i: rng.randint(0, 2**31, size=(4, 2)).astype(np.uint32)
             for i in ids}
    stores = (Design1Store(), Design2Store(part_size=3),
              ref_bandstore.Design2Store(part_size=3))
    for store in stores:
        for i in ids:
            store.insert_document(i, bands[i])
        store.commit()
    s1, s2, ref2 = stores
    assert _store_rows(s2, 4) == _store_rows(ref2, 4)
    for j in range(4):
        d2, v2 = s2.read_band(j)
        assert sorted(d2.tolist()) == sorted(ids)
        assert d2.dtype == np.int64 and v2.dtype == np.uint32
        for doc, val in zip(d2, v2):
            np.testing.assert_array_equal(val, bands[int(doc)][j])
        d1, v1 = s1.read_band(j)
        o1, o2 = np.argsort(d1), np.argsort(d2)
        np.testing.assert_array_equal(d1[o1], d2[o2])
        np.testing.assert_array_equal(v1[o1], v2[o2])
    assert s1.n_entries() == s2.n_entries() == 4 * len(ids)
    assert (s2.n_writes, s2.write_bytes) == (ref2.n_writes, ref2.write_bytes)


def test_design2_store_reads_legacy_v1_blobs():
    vals = np.random.RandomState(1).randint(
        0, 2**31, size=(5, 2)).astype(np.uint32)
    s2 = Design2Store()
    s2.conn.execute("INSERT INTO band2 VALUES (?,?,?,?)",
                    (0, 0, 10, vals.tobytes()))
    docs, got = s2.read_band(0)
    np.testing.assert_array_equal(docs, np.arange(10, 15))
    np.testing.assert_array_equal(got, vals)


def test_streaming_resumed_ingest_noncontiguous_ids():
    """Resumed ingest writes non-contiguous ids inside one part; gap ids
    stay singletons, in both packages alike."""
    notes_a = make_i2b2_like(5, seed=11)
    notes_a[3] = notes_a[1]
    notes_b = make_i2b2_like(5, seed=12)
    notes_b[0] = notes_a[1]
    ref_cfg, cfg = _configs()
    sd = StreamingDedup(cfg, chunk_docs=8, device="cpu")
    ref_sd = ref_streaming.StreamingDedup(ref_cfg, chunk_docs=8)
    for s in (sd, ref_sd):
        s.ingest(notes_a)
        s.n_docs = 42                       # resume after a corpus gap
        s.ingest(notes_b)
    assert sd.n_docs == 47
    docs0, _ = sd.store.read_band(0)
    assert sorted(docs0.tolist()) == [0, 1, 2, 3, 4, 42, 43, 44, 45, 46]
    assert _store_rows(sd.store, cfg.num_bands) == _store_rows(
        ref_sd.store, cfg.num_bands)
    labels = sd.cluster()[0].components()
    np.testing.assert_array_equal(labels, ref_sd.cluster()[0].components())
    assert labels[1] == labels[3] == labels[42]
    assert (labels[5:42] == np.arange(5, 42)).all()
    # doc_id_base: resumed ingest into a fresh store, and a session over it.
    sd2 = StreamingDedup(cfg, chunk_docs=8, doc_id_base=1000, device="cpu")
    ref_sd2 = ref_streaming.StreamingDedup(ref_cfg, chunk_docs=8,
                                           doc_id_base=1000)
    for s in (sd2, ref_sd2):
        s.ingest(notes_a)
    assert sorted(sd2.store.read_band(0)[0].tolist()) == list(range(1000, 1005))
    sess = DedupSession.over_store(sd2)
    ref_sess = ref_session.DedupSession.over_store(ref_sd2)
    _assert_same(sess.snapshot(), ref_sess.snapshot())
    labels2 = sess.snapshot().labels
    assert labels2[1001] == labels2[1003]
    _assert_same(sess.ingest(notes_b), ref_sess.ingest(notes_b))


# -- the store interface and blob schema (test_bandstore_backends.py) ---------

def test_legacy_v1_and_v2_blobs_decode_through_interface(tmp_path):
    path = str(tmp_path / "legacy.db")
    store = Design2Store(path, part_size=4)
    bands = np.random.default_rng(5).integers(0, 50, size=(8, 3, 2),
                                              dtype=np.uint32)
    store.put_band_rows(range(8), bands)
    store.commit()
    ref = {j: store.read_band(j) for j in range(3)}
    # Every part rewritten as a v1 blob (raw values, ids implied by doc0).
    conn = sqlite3.connect(path)
    for band_id, part_id, doc0, blob in conn.execute(
            "SELECT band_id, part_id, doc0, vals FROM band2").fetchall():
        _, vals = _decode_part(blob, doc0)
        conn.execute("UPDATE band2 SET vals=? WHERE band_id=? AND part_id=?",
                     (np.ascontiguousarray(vals, np.uint32).tobytes(),
                      band_id, part_id))
    conn.commit()
    conn.close()
    legacy = Design2Store(path, part_size=4)
    for j in range(3):
        np.testing.assert_array_equal(legacy.read_band(j)[0], ref[j][0])
        np.testing.assert_array_equal(legacy.read_band(j)[1], ref[j][1])
    runs = [[(br.band_id, br.sorted_vals.tolist(), br.sorted_docs.tolist())
             for br in s.iter_band_runs(3)] for s in (store, legacy)]
    assert runs[0] == runs[1]
    ref_legacy = ref_bandstore.Design2Store(path, part_size=4)
    assert runs[1] == [(br.band_id, br.sorted_vals.tolist(),
                        br.sorted_docs.tolist())
                       for br in ref_legacy.iter_band_runs(3)]


def test_v2_blob_roundtrips_noncontiguous_ids():
    store = Design2Store(part_size=3)
    ids = [5, 17, 900]
    for d in ids:
        store.insert_document(d, np.array([[d, d + 1]], dtype=np.uint32))
    store.commit()
    docs, vals = store.read_band(0)
    assert docs.tolist() == ids
    blob = _encode_part_v2(np.array(ids, np.int64), vals)
    # The same bytes as the reference's codec, which decodes them alike.
    assert blob == ref_bandstore._encode_part_v2(np.array(ids, np.int64), vals)
    for decode in (_decode_part, ref_bandstore._decode_part):
        d2, v2 = decode(blob, 0)
        assert d2.tolist() == ids
        np.testing.assert_array_equal(v2, vals)


def test_make_store_factory():
    assert STORE_KINDS == ref_bandstore.STORE_KINDS
    store = make_store("memory", part_size=7)
    assert isinstance(store, Design2Store) and isinstance(store,
                                                          BandStoreBackend)
    assert store.part_size == 7 and store.kind == "memory"
    sqlite_store = make_store("sqlite", num_bands=5)
    assert isinstance(sqlite_store, SqliteBandStore) and isinstance(
        sqlite_store, BandStoreBackend)
    assert sqlite_store.kind == "sqlite" and sqlite_store.num_bands == 5
    with pytest.raises(ValueError, match="unknown store"):
        make_store("cassandra")
    with pytest.raises(ValueError, match="unknown store"):
        DedupConfig(store="cassandra")
    assert DedupConfig(store="sqlite").store == "sqlite"


def test_probe_keys_and_accounting_match_reference():
    bands = np.random.default_rng(6).integers(0, 4, size=(20, 3, 2),
                                              dtype=np.uint32)
    got_store, want_store = Design2Store(part_size=6), \
        ref_bandstore.Design2Store(part_size=6)
    for s in (got_store, want_store):
        s.put_band_rows(np.arange(20), bands)
        s.commit()
    got, want = got_store.probe_keys(bands[:7]), want_store.probe_keys(
        bands[:7])
    assert [g.tolist() for g in got[0]] == [w.tolist() for w in want[0]]
    assert got[1] == want[1]
    assert got_store.n_entries() == want_store.n_entries() == 60
    assert got_store.file_size_bytes() == want_store.file_size_bytes() > 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_file_reads_the_same_in_both_packages(writer, tmp_path):
    """A Design-2 store file written by one package (parts of a
    non-contiguous id range, one compaction) reads the same through the
    other: rows, runs, probes and entry counts."""
    path = str(tmp_path / "bands.db")
    mods = {"reference": ref_bandstore.Design2Store, "port": Design2Store}
    reader = "port" if writer == "reference" else "reference"
    rng = np.random.default_rng(8)
    ids = np.array(list(range(12)) + list(range(40, 52)), dtype=np.int64)
    bands = rng.integers(0, 5, size=(len(ids), 4, 2), dtype=np.uint32)
    w = mods[writer](path, part_size=5)
    w.put_band_rows(ids, bands)
    w.commit()
    w.compact([3, 41], {3: 0, 41: 40}.__getitem__)
    w.put_band_rows([60], bands[:1])
    w.commit()
    want = _store_rows(w, 4)
    w.conn.close()
    r = mods[reader](path, part_size=5)
    assert _store_rows(r, 4) == want
    assert r.n_entries() == sum(len(d) for d, _ in want)
    w2 = mods[writer](path, part_size=5)
    assert [(br.sorted_vals.tolist(), br.sorted_docs.tolist())
            for br in r.iter_band_runs(4)] == \
        [(br.sorted_vals.tolist(), br.sorted_docs.tolist())
         for br in w2.iter_band_runs(4)]
    assert [p.tolist() for p in r.probe_keys(bands[:6])[0]] == \
        [p.tolist() for p in w2.probe_keys(bands[:6])[0]]
