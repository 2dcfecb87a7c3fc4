"""Port parity of the sqlite band-store tier.

``SqliteBandStore`` (the Bloom-first key-level disk index, also a host
session's cross-step ``BandIndex``), ``DiskSignatureVerifier`` (rows off
disk, K2' on the verifier's device: its plain version here),
``store="sqlite"`` for host and streaming sessions, the read path's
probe through ``SessionView.band_store`` and ``make_store`` /
``candidate_pairs_from_store``.  Each case runs ``repro_torch``
(``device="cpu"``) beside ``repro`` and, where the reference compares
tiers, beside the port's memory tier: labels, (a, b, sim) lists,
``filter_only_hits``, ``compacted_keys``, the stores' ``stats()`` and
write counters and their raw table rows are equal.  Mirrors the sqlite
half of ``tests/test_bandstore_backends.py`` (not its sharded case); a
store file written by either package opens in the other.
"""
import dataclasses
import shutil
import sqlite3

import numpy as np
import pytest

import repro.core.bandstore as ref_bandstore
import repro.core.pipeline as ref_pipeline
import repro.core.query as ref_query
import repro.core.session as ref_session
import repro.core.streaming as ref_streaming
from repro.core.retention import RetentionPolicy as RefPolicy
from repro.core.unionfind import ThresholdUnionFind as RefUnionFind
from repro.data import inject_near_duplicates, make_i2b2_like
from repro_torch.core import (
    DedupConfig,
    DedupPipeline,
    DedupSession,
    RetentionPolicy,
    query_view,
)
from repro_torch.core.bandstore import (
    BandStoreBackend,
    Design2Store,
    DiskSignatureVerifier,
    SqliteBandStore,
    candidate_pairs_from_store,
    make_store,
)
from repro_torch.core.session import BandIndex
from repro_torch.core.streaming import StreamingDedup
from repro_torch.core.unionfind import ThresholdUnionFind
from repro_torch.core.verify import SignatureVerifier

COUNTERS = ("pairs_generated", "pairs_evaluated", "pairs_excluded",
            "pairs_above_edge", "unions_done", "unions_rejected",
            "verify_batches")


def _corpus(n=48, dups=32, seed=0):
    notes = make_i2b2_like(n, seed=seed)
    notes, _ = inject_near_duplicates(notes, dups, frac_low=0.0,
                                      frac_high=0.005, seed=seed + 1)
    order = np.random.RandomState(seed + 2).permutation(len(notes))
    return [notes[i] for i in order]


def _chunks(notes, k=4):
    return [[notes[i] for i in idx]
            for idx in np.array_split(np.arange(len(notes)), k)]


# Every session case ingests the same 80 notes in 4 chunks of 20 (the
# streaming ones flush every 20): the reference compiles its signature
# stages once per chunk shape, so shared shapes keep the file fast.
CHUNKS = _chunks(_corpus())


def _run(store, backend, chunks, *, ref=False, retention=None, exact=False,
         config_kw=None, **kw):
    """A session of either package over ``chunks`` (``ingest_stream``);
    ``retention`` is a dict of ``RetentionPolicy`` fields."""
    fields = dict(exact_verification=exact, store=store, **(config_kw or {}))
    if ref:
        sess = ref_session.DedupSession(
            ref_pipeline.DedupConfig(**fields), backend=backend,
            retention=RefPolicy(**retention) if retention else None, **kw)
    else:
        sess = DedupSession(
            DedupConfig(**fields), backend=backend, device="cpu",
            retention=RetentionPolicy(**retention) if retention else None,
            **kw)
    for snap in sess.ingest_stream(chunks):
        pass
    return sess, snap


@pytest.fixture(scope="module")
def run():
    """``_run`` memoized over this module: cases that read the same
    session (and never mutate it) share one run."""
    cache = {}

    def get(store, backend, *, ref=False, retention=None, exact=False,
            chunk_docs=None):
        key = (store, backend, ref, tuple(sorted((retention or {}).items())),
               exact, chunk_docs)
        if key not in cache:
            kw = {} if chunk_docs is None else {"chunk_docs": chunk_docs}
            cache[key] = _run(store, backend, CHUNKS, ref=ref,
                              retention=retention, exact=exact, **kw)
        return cache[key]

    return get


def _store(sess):
    """The session's sqlite state: the host index or the streaming store."""
    return sess.band_index if sess.backend == "host" else sess._impl.sd.store


def _raw(store):
    """Every row of the three tables, in rowid (insertion) order."""
    conn = store.conn
    return tuple(conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                 for t in ("bandkeys", "docentries", "sigs"))


def _stats(store):
    s = store.stats()
    s.pop("file_bytes")
    return s


def _assert_parity(a, b):
    """The reference's tier contract: labels, sims, filter-only hits."""
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.pairs == b.pairs
    assert a.filter_only_hits == b.filter_only_hits


def _assert_same(got, want):
    """Port snapshot == reference snapshot, field by field."""
    _assert_parity(got, want)
    assert got.n_docs == want.n_docs
    for f in COUNTERS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert (got.retained_rows, got.evicted) == (want.retained_rows,
                                                want.evicted)


def _assert_same_store(got, want):
    assert _stats(got) == _stats(want)
    assert (got.n_writes, got.write_bytes, got.compacted_keys) == (
        want.n_writes, want.write_bytes, want.compacted_keys)
    assert _raw(got) == _raw(want)


# -- sessions: sqlite == memory, port == reference ----------------------------

@pytest.mark.parametrize("backend", ["host", "streaming"])
@pytest.mark.parametrize("retained", [False, True])
def test_sqlite_session_matches_memory_and_reference(backend, retained, run):
    kw = dict(retention=dict(lru_window=10) if retained else None)
    if backend == "streaming":
        kw["chunk_docs"] = 20
    sess, got = run("sqlite", backend, **kw)
    _, mem = run("memory", backend, **kw)
    ref, want = run("sqlite", backend, ref=True, **kw)
    _assert_parity(got, mem)
    _assert_same(got, want)
    _assert_same_store(_store(sess), _store(ref))
    if retained:
        assert got.evicted == mem.evicted > 0
    if backend == "host":
        assert isinstance(sess.band_index, SqliteBandStore)
    else:
        # The streaming backend's index stays in memory (unused).
        assert isinstance(sess.band_index, BandIndex)
        assert isinstance(sess.verifier, DiskSignatureVerifier)
        assert (sess.verifier.cache_hits, sess.verifier.cache_misses) == (
            ref.verifier.cache_hits, ref.verifier.cache_misses)


def test_sqlite_host_exact_mode_matches_memory_and_reference(run):
    sess, got = run("sqlite", "host", exact=True)
    _, mem = run("memory", "host", exact=True)
    ref, want = run("sqlite", "host", ref=True, exact=True)
    _assert_parity(got, mem)
    _assert_same(got, want)
    _assert_same_store(sess.band_index, ref.band_index)


def test_sqlite_matches_memory_and_reference_under_key_budget(run):
    """The lossy path: budget compaction (by last touch) and the
    filter-only-hit count agree across tiers and packages."""
    ret = dict(lru_window=10, band_key_budget=16, bloom_bits=1 << 16)
    sess, got = run("sqlite", "host", retention=ret)
    mem_sess, mem = run("memory", "host", retention=ret)
    ref, want = run("sqlite", "host", ref=True, retention=ret)
    _assert_parity(got, mem)
    _assert_same(got, want)
    _assert_same_store(sess.band_index, ref.band_index)
    assert sess.band_index.compacted_keys == \
        mem_sess.band_index.compacted_keys > 0
    assert got.filter_only_hits > 0
    assert sess.band_index.export_maps() == mem_sess.band_index.export_maps()


# -- the read path over a sqlite view -----------------------------------------

def test_query_view_over_sqlite_view(tmp_path, run):
    """Probes go through the store's Bloom-first ``probe_keys``; results
    equal the memory tier's dict walk and the reference's sqlite view,
    and a view held across a later ingest sees no doc newer than it."""
    notes, chunks = _corpus(), CHUNKS
    mem, _ = run("memory", "host")
    sess, _ = _run("sqlite", "host", chunks[:3],
                   store_path=str(tmp_path / "port.db"))
    ref, _ = _run("sqlite", "host", chunks[:3], ref=True,
                  store_path=str(tmp_path / "ref.db"))
    old, ref_old = sess.view(), ref.view()
    sess.ingest(chunks[3])
    ref.ingest(chunks[3])
    view, ref_view = sess.view(), ref.view()
    assert view.band_store is sess.band_index
    assert view.band_maps == () and view.band_filters == ()
    pipe = DedupPipeline(DedupConfig(exact_verification=False), device="cpu")
    queries = notes[:40] + ["an entirely novel note text " * 6]
    sig, bands = pipe.compute_arrays(pipe.tokenize(queries))
    for q in (3, len(queries)):
        got = query_view(view, bands[:q], sig=sig[:q])
        assert got == query_view(mem.view(), bands[:q], sig=sig[:q])
        want = ref_query.query_view(ref_view, bands[:q], sig=sig[:q])
        assert [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want]
    stale = query_view(old, bands, sig=sig)
    assert any((c >= old.n_docs).any()
               for c in old.band_store.probe_keys(bands)[0])
    assert all(d < old.n_docs for r in stale for d, _ in r.candidates)
    assert [dataclasses.astuple(r) for r in stale] == [
        dataclasses.astuple(r)
        for r in ref_query.query_view(ref_old, bands, sig=sig)]
    assert sess.band_index.probe_stats(bands) == \
        ref.band_index.probe_stats(bands)


# -- streaming store compaction -----------------------------------------------

def test_streaming_store_compaction_bounds_row_count(run):
    """Under eviction the sqlite store rewrites evicted docs' rows onto
    their roots: fewer entries, the same clusters, the reference's rows."""
    plain, pl_snap = run("sqlite", "streaming", chunk_docs=20)
    sess, snap = run("sqlite", "streaming", chunk_docs=20,
                     retention=dict(lru_window=10))
    ref, want = run("sqlite", "streaming", ref=True, chunk_docs=20,
                    retention=dict(lru_window=10))
    _assert_parity(snap, pl_snap)
    _assert_same(snap, want)
    assert snap.evicted > 0
    store = sess._impl.sd.store
    assert store.n_entries() < plain._impl.sd.store.n_entries()
    assert store.n_signatures() == snap.retained_rows < snap.n_docs
    _assert_same_store(store, ref._impl.sd.store)


# -- the Bloom-first probe ------------------------------------------------------

def _probe_case(seed, n_docs, n_queries, n_bands, vocab):
    """The probe never misses: it equals the generic dict walk over the
    same rows and the reference's probe, and its accounting adds up."""
    rng = np.random.default_rng(seed)
    bands = rng.integers(0, vocab, size=(n_docs, n_bands, 2), dtype=np.uint32)
    qbands = rng.integers(0, vocab, size=(n_queries, n_bands, 2),
                          dtype=np.uint32)
    stores = [cls(num_bands=n_bands, primary_bloom_bits=1 << 10)
              for cls in (SqliteBandStore, ref_bandstore.SqliteBandStore)]
    for s in stores:
        s.put_band_rows(np.arange(n_docs), bands)
        s.commit()
    got, hits = stores[0].probe_keys(qbands)
    want, _ = BandStoreBackend.probe_keys(stores[0], qbands)
    ref, ref_hits = stores[1].probe_keys(qbands)
    assert [g.tolist() for g in got] == [w.tolist() for w in want] == \
        [r.tolist() for r in ref]
    assert hits == ref_hits == [0] * n_queries
    stats = stores[0].probe_stats(qbands)
    assert stats == stores[1].probe_stats(qbands)
    assert stats["bloom_maybe"] == stats["disk_hits"] + stats["bloom_fps"]
    assert stats["disk_hits"] <= stats["bloom_maybe"] <= stats["probes"]


def test_bloom_first_probe_never_misses_hypothesis():
    from hypothesis import given, settings, strategies as st

    @settings(deadline=None, max_examples=5, database=None)
    @given(seed=st.integers(0, 2**10), n_docs=st.integers(1, 40),
           n_queries=st.integers(1, 8), n_bands=st.integers(1, 4),
           vocab=st.integers(2, 12))
    def prop(seed, n_docs, n_queries, n_bands, vocab):
        _probe_case(seed, n_docs, n_queries, n_bands, vocab)

    prop()


@pytest.mark.parametrize("case", [(0, 1, 1, 1, 2), (3, 40, 8, 4, 12),
                                  (7, 25, 5, 2, 3)])
def test_bloom_first_probe_never_misses_fixed(case):
    _probe_case(*case)


def test_probe_keys_is_pure():
    """Probing mutates nothing: no recency refresh, no counter, no row."""
    rng = np.random.default_rng(1)
    bands = rng.integers(0, 8, size=(12, 4, 2), dtype=np.uint32)
    store = SqliteBandStore(num_bands=4, key_budget=3, track_entries=True)
    store.match_then_insert(bands, 0)
    assert store.compacted_keys > 0

    def state():
        return (store._seq, store.filter_only_hits, store.compacted_keys,
                store.n_writes, store.write_bytes, _raw(store),
                [f._words.tobytes() for f in store._primary])

    before = state()
    store.probe_keys(bands)
    store.probe_stats(bands)
    assert state() == before


# -- SqliteBandStore against BandIndex and the reference, unit by unit ---------

def test_sqlite_index_matches_bandindex_and_reference():
    """Same edges, compaction victims, filter-only hits and evictions as
    ``session.BandIndex``; the reference's rows, ``seq`` and counters."""
    rng = np.random.default_rng(2)
    chunks = [rng.integers(0, 6, size=(6, 2, 2), dtype=np.uint32)
              for _ in range(4)]
    mem = BandIndex(2, key_budget=4, track_entries=True)
    dsk = SqliteBandStore(num_bands=2, key_budget=4, track_entries=True)
    ref = ref_bandstore.SqliteBandStore(num_bands=2, key_budget=4,
                                        track_entries=True)
    uf, ref_uf = ThresholdUnionFind(64, 0.3), RefUnionFind(64, 0.3)
    base = 0
    for t, bands in enumerate(chunks):
        ea = mem.match_then_insert(bands, base)
        eb = dsk.match_then_insert(bands, base)
        np.testing.assert_array_equal(ea, eb)
        np.testing.assert_array_equal(eb, ref.match_then_insert(bands, base))
        if t == 1:
            for a, b in ea.tolist():
                uf.union(a, b, 1.0)
                ref_uf.union(a, b, 1.0)
            evict = [d for d in range(base) if uf.find(d) != d]
            mem.evict(evict, uf.find)
            dsk.evict(evict, uf.find)
            ref.evict(evict, ref_uf.find)
        base += len(bands)
    assert mem.export_maps() == dsk.export_maps() == ref.export_maps()
    assert mem.compacted_keys == dsk.compacted_keys > 0
    assert mem.filter_only_hits == dsk.filter_only_hits
    ms, ds = mem.stats(), dsk.stats()
    for k in ("n_keys", "n_entries", "n_docs_tracked", "compacted_keys",
              "filter_only_hits", "bloom_bytes"):
        assert ms[k] == ds[k], k
    _assert_same_store(dsk, ref)
    assert [f._words.tolist() if f is not None else None
            for f in dsk.export_filters()] == \
        [f._words.tolist() if f is not None else None
         for f in ref.export_filters()]


def test_sqlite_index_evict_requires_track_entries():
    for cls in (SqliteBandStore, ref_bandstore.SqliteBandStore):
        with pytest.raises(ValueError, match="track_entries"):
            cls(num_bands=1).evict([0], lambda d: d)


def test_put_band_rows_equals_the_insert_loop():
    """The batched ``put_band_rows`` leaves the rows, ``seq`` values and
    write counters of ``insert_document`` called doc by doc: over keys
    repeated within the chunk, keys already stored and keys a budget
    compacted away (still in the primary filter, gone from disk)."""
    rng = np.random.default_rng(12)
    first = rng.integers(0, 5, size=(10, 3, 2), dtype=np.uint32)
    chunk = rng.integers(0, 5, size=(9, 3, 2), dtype=np.uint32)
    stores = [cls(num_bands=3, key_budget=6)
              for cls in (SqliteBandStore, SqliteBandStore,
                          ref_bandstore.SqliteBandStore)]
    for s in stores:
        s.match_then_insert(first, 0)
        assert s.compacted_keys > 0
    ids = np.arange(20, 29)
    stores[0].put_band_rows(ids, chunk)
    for i, d in enumerate(ids):
        stores[1].insert_document(d, chunk[i])
    stores[2].put_band_rows(ids, chunk)
    for s in stores[1:]:
        assert s._seq == stores[0]._seq
        assert s._key_counts == stores[0]._key_counts
        _assert_same_store(stores[0], s)


# -- disk-resident signature rows -----------------------------------------------

def test_disk_signature_verifier_bit_parity_and_cache():
    rng = np.random.RandomState(2)
    sig = rng.randint(0, 50, size=(12, 40)).astype(np.uint32)
    pairs = np.array([(0, 8), (2, 9), (5, 10), (3, 11), (0, 2)],
                     dtype=np.int64)
    stores = [SqliteBandStore(num_bands=1),
              ref_bandstore.SqliteBandStore(num_bands=1)]
    for s in stores:
        s.put_signatures(np.arange(12), sig)
    v = DiskSignatureVerifier(stores[0], 40, cache_rows=4, device="cpu")
    ref = ref_bandstore.DiskSignatureVerifier(stores[1], 40, cache_rows=4)
    want = SignatureVerifier(sig, device="cpu")(pairs)
    for _ in range(2):
        got = v(pairs)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref(pairs))
    assert v.cache_hits > 0 and v.cache_misses > 0
    assert (v.cache_hits, v.cache_misses) == (ref.cache_hits,
                                              ref.cache_misses)
    assert list(v._cache) == list(ref._cache)      # the same LRU order
    assert len(v._cache) <= 4
    assert v.n_live_rows == 12
    np.testing.assert_array_equal(v.rows_for([3, 0]), sig[[3, 0]])


def test_disk_signature_verifier_release_rows_bounds_disk():
    rng = np.random.RandomState(3)
    sig = rng.randint(0, 50, size=(8, 16)).astype(np.uint32)
    store = SqliteBandStore(num_bands=1)
    v = DiskSignatureVerifier(store, 16, device="cpu")
    v.extend_signatures(np.arange(8), sig)
    assert store.n_signatures() == 8
    v(np.array([[1, 4]]))
    v.release_rows([1, 4])
    assert store.n_signatures() == 6 and 1 not in v._cache
    ref = ref_bandstore.DiskSignatureVerifier(
        ref_bandstore.SqliteBandStore(num_bands=1), 16)
    msgs = []
    for verifier in (v, ref):
        with pytest.raises(KeyError) as exc:
            verifier(np.array([[1, 5]]))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "doc 1 has no retained" in msgs[0]
    assert v(np.array([[2, 3]]))[0] == (sig[2] == sig[3]).mean(
        dtype=np.float32)


def test_disk_signature_verifier_default_device_raises_without_cuda():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiskSignatureVerifier(SqliteBandStore(num_bands=1), 4)


def test_streaming_sqlite_keeps_no_signature_matrix():
    """A streaming sqlite session verifies off the store's rows: no host
    cache, no device rows, no session matrix."""
    sess, snap = _run("sqlite", "streaming", CHUNKS[:3], chunk_docs=20)
    v = sess.verifier
    assert isinstance(v, DiskSignatureVerifier)
    assert v.device.type == "cpu"
    sd = sess._impl.sd
    assert sd._sig_cache == {} and sd._device_rows is None
    assert sess.signatures.shape == (0, sess.config.num_hashes)
    assert v.n_live_rows == snap.n_docs == snap.retained_rows
    assert sess.stage_timings["phase1_store_s"] > 0
    assert {"rescan_s", "engine_s", "phase1_s"} <= set(sess.stage_timings)


def test_default_verifier_needs_the_rows():
    cfg = DedupConfig(store="sqlite", exact_verification=False)
    sd = StreamingDedup(cfg, chunk_docs=20, device="cpu")
    ref = ref_streaming.StreamingDedup(ref_pipeline.DedupConfig(
        store="sqlite", exact_verification=False), chunk_docs=20)
    notes = CHUNKS[0]
    for s in (sd, ref):
        s.ingest(notes, keep_signatures=False)
    for s in (sd, ref):
        with pytest.raises(ValueError, match="store holds 0 of 20"):
            s.default_verifier()
    kept = StreamingDedup(cfg, chunk_docs=20, device="cpu")
    kept.ingest(notes)
    v = kept.default_verifier()
    assert isinstance(v, DiskSignatureVerifier) and v.device.type == "cpu"


# -- factory, reopening, scans ---------------------------------------------------

def test_make_store_factory():
    assert isinstance(make_store("memory"), Design2Store)
    store = make_store("sqlite", num_bands=7)
    assert isinstance(store, SqliteBandStore) and store.kind == "sqlite"
    assert store.num_bands == 7
    with pytest.raises(ValueError, match="unknown store"):
        make_store("cassandra")


def test_sqlite_store_reopens_from_file(tmp_path):
    """Primary filters, key counts and the clock rebuild from the rows."""
    path = str(tmp_path / "bands.db")
    bands = np.random.default_rng(4).integers(0, 10, size=(10, 3, 2),
                                              dtype=np.uint32)
    s1 = SqliteBandStore(path, num_bands=3)
    s1.put_band_rows(np.arange(10), bands)
    s1.commit()
    probe = s1.probe_keys(bands[:4])
    s1.conn.close()
    s2 = SqliteBandStore(path, num_bands=3)
    got = s2.probe_keys(bands[:4])
    assert [g.tolist() for g in got[0]] == [w.tolist() for w in probe[0]]
    assert s2._key_counts == s1._key_counts
    assert s2._seq == s1._seq + 1
    assert s2.file_size_bytes() > 0


def test_iter_band_runs_and_candidate_pairs_match_across_backends():
    bands = np.random.default_rng(6).integers(0, 4, size=(20, 3, 2),
                                              dtype=np.uint32)
    mem = make_store("memory", part_size=6)
    dsk = make_store("sqlite", num_bands=3)
    ref = ref_bandstore.make_store("sqlite", num_bands=3)
    for s in (mem, dsk, ref):
        s.put_band_rows(np.arange(20), bands)
        s.commit()

    def runs(store):
        return [(br.band_id, br.sorted_vals.tolist(), br.sorted_docs.tolist())
                for br in store.iter_band_runs(3)]

    assert runs(mem) == runs(dsk) == runs(ref)
    assert mem.n_entries() == dsk.n_entries() == ref.n_entries() == 60
    for cap in (None, 2):
        got = candidate_pairs_from_store(dsk, 3, cap)
        np.testing.assert_array_equal(got, candidate_pairs_from_store(
            mem, 3, cap))
        np.testing.assert_array_equal(
            got, ref_bandstore.candidate_pairs_from_store(ref, 3, cap))


# -- files across packages --------------------------------------------------------

def _write(cls, path, bands, sig):
    """The writes of a resumable store: an indexed chunk under a key
    budget, an eviction, a streamed chunk and signature rows."""
    s = cls(path, num_bands=4, key_budget=12, track_entries=True)
    s.match_then_insert(bands[:12], 0)
    s.evict([3, 5], {3: 0, 5: 1}.__getitem__)
    s.put_band_rows(np.arange(12, 20), bands[12:20])
    s.put_signatures(np.arange(20), sig)
    s.commit()
    return s


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_file_opens_in_both_packages(writer, tmp_path):
    """A file one package wrote opens in the other: the same band rows,
    probes, stats, maps and signature rows; after the same further calls
    in both, the same raw rows.  And the same calls from an empty file
    leave the same raw rows in both packages."""
    classes = {"reference": ref_bandstore.SqliteBandStore,
               "port": SqliteBandStore}
    rng = np.random.default_rng(8)
    bands = rng.integers(0, 5, size=(28, 4, 2), dtype=np.uint32)
    sig = rng.integers(0, 2**32, size=(20, 16), dtype=np.uint32)
    src = str(tmp_path / "src.db")
    w = _write(classes[writer], src, bands, sig)
    w.conn.close()
    twin = _write(classes["port" if writer == "reference" else "reference"],
                  str(tmp_path / "twin.db"), bands, sig)
    assert _raw(twin) == _raw(classes[writer](src, num_bands=4))
    readers = {}
    for name, cls in classes.items():
        path = str(tmp_path / f"{name}.db")
        shutil.copy(src, path)
        readers[name] = cls(path, num_bands=4, key_budget=12,
                            track_entries=True)
    got, want = readers["port"], readers["reference"]
    for j in range(4):
        for x, y in zip(got.read_band(j), want.read_band(j)):
            np.testing.assert_array_equal(x, y)
    gp, wp = got.probe_keys(bands[:9]), want.probe_keys(bands[:9])
    assert [g.tolist() for g in gp[0]] == [w.tolist() for w in wp[0]]
    assert gp[1] == wp[1]
    assert _stats(got) == _stats(want)
    assert got.export_maps() == want.export_maps()
    for d in (0, 7, 19, 25):
        g, w = got.get_signature(d), want.get_signature(d)
        assert (g is None and w is None) or np.array_equal(g, w)
    np.testing.assert_array_equal(got.get_signature(7), sig[7])
    # The reopened stores continue alike.
    edges = [s.match_then_insert(bands[20:], 20) for s in (got, want)]
    for s in (got, want):
        s.put_band_rows([40, 41], bands[:2])
        s.commit()
    np.testing.assert_array_equal(edges[0], edges[1])
    assert len(edges[0]) > 0
    _assert_same_store(got, want)
    conn = sqlite3.connect(str(tmp_path / "port.db"))
    assert conn.execute("SELECT COUNT(*) FROM bandkeys").fetchone()[0] == \
        sum(got._key_counts)
    conn.close()
