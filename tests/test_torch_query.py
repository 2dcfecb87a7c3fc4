"""Port parity of the read path: ``SessionView``, ``query_view``,
``DedupQueryService`` and the ``REPRO_SANITIZE`` view tripwire.

The port's ``numpy`` results equal the reference's ``numpy`` results on
the same corpus, and its ``torch`` and ``kernel`` backends (plain
versions here, ``device="cpu"``) equal its ``numpy`` backend.  Mirrors
the host cases of ``tests/test_query_service.py`` (its retention cases
too) and ``tests/test_sanitize.py`` (not ``maybe_install``).
"""
import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.query as ref_query
import repro.core.sanitize as ref_sanitize
from repro.data import inject_near_duplicates, make_i2b2_like
from repro_torch.core import (
    DedupConfig,
    DedupPipeline,
    DedupQueryService,
    DedupSession,
    QueryResult,
    RetentionPolicy,
    query_view,
    sanitize,
)
from repro_torch.core.query import probe_candidates
from repro_torch.core.shingle import pow2_bucket


def _corpus(n=40, dups=25, seed=0):
    notes = make_i2b2_like(n, seed=seed)
    notes, _ = inject_near_duplicates(notes, dups, frac_low=0.0,
                                      frac_high=0.005, seed=seed + 1)
    return notes


def _warm(notes, *, exact=False, chunks=1, ref=False, retention=None,
          **cfg):
    """A warm host session of the port (or of the reference).
    ``retention``: ``RetentionPolicy`` fields, for either package."""
    if ref:
        sess = ref_core.DedupSession(ref_core.DedupConfig(
            exact_verification=exact, store="memory", **cfg), backend="host",
            retention=(ref_core.RetentionPolicy(**retention)
                       if retention is not None else None))
    else:
        sess = DedupSession(DedupConfig(exact_verification=exact, **cfg),
                            retention=(RetentionPolicy(**retention)
                                       if retention is not None else None),
                            device="cpu")
    for idx in np.array_split(np.arange(len(notes)), chunks):
        snap = sess.ingest([notes[i] for i in idx])
    return sess, snap


def _values(results):
    """QueryResults as tuples of their fields (the two packages' result
    classes are distinct, so their instances never compare equal)."""
    return [dataclasses.astuple(r) for r in results]


def _session_state(sess):
    """Everything a query could illegally touch."""
    return (
        sess.uf.components()[: sess.n_docs].tolist(),
        list(sess.acc.pairs),
        sess.n_docs,
        sess.steps_ingested,
        sess.acc.stats.pairs_evaluated,
        sess.acc.stats.unions_done,
        sess.band_index.stats(),
        sess.band_index.filter_only_hits,
    )


# -- against the reference -------------------------------------------------------

@pytest.mark.parametrize("exact", [False, True])
def test_query_results_match_reference(exact):
    notes = _corpus()
    queries = notes + ["utterly novel content " * 20]
    sess, snap = _warm(notes, exact=exact, chunks=3)
    ref_sess, ref_snap = _warm(notes, exact=exact, chunks=3, ref=True)
    np.testing.assert_array_equal(snap.labels, ref_snap.labels)
    got = DedupQueryService(sess).query(queries)
    want = ref_core.DedupQueryService(ref_sess, backend="numpy").query(queries)
    assert _values(got) == _values(want)
    # A batch answers as its queries one at a time.
    assert [DedupQueryService(sess).query([q])[0] for q in queries[:5]] \
        == got[:5]


def test_byte_session_query_bytes_and_microbatches_match_reference():
    notes = _corpus(30, 20, seed=4)
    queries = notes[:9] + ["something else entirely " * 20]
    sess, _ = _warm(notes, chunks=2, byte_ingest=True)
    ref_sess, _ = _warm(notes, chunks=2, ref=True, byte_ingest=True)
    want = _values(ref_core.DedupQueryService(ref_sess).query_bytes(queries))
    for backend in ("numpy", "torch", "kernel"):
        svc = DedupQueryService(sess, backend=backend, max_batch=4)
        assert _values(svc.query_bytes(queries)) == want
        assert _values(svc.query(queries)) == want
        rids = [svc.submit(t) for t in queries]
        by_rid = {r.rid: r for r in svc.run_until_drained()}
        assert _values(by_rid[rid].result for rid in rids) == want


def test_microbatch_and_admit_match_reference():
    notes = _corpus()
    queries = notes[:13] + ["novel text " * 25]
    got_sess, _ = _warm(notes, chunks=2)
    ref_sess, _ = _warm(notes, chunks=2, ref=True)
    out = []
    for svc in (DedupQueryService(got_sess, max_batch=4),
                ref_core.DedupQueryService(ref_sess, max_batch=4)):
        rids = [svc.submit(t) for t in queries]
        by_rid = {r.rid: r for r in svc.run_until_drained()}
        snap = svc.admit(["previously unseen admission note " * 10])
        out.append((_values(by_rid[rid].result for rid in rids),
                    _values(svc.query(queries[-2:] + [
                        "previously unseen admission note " * 10])),
                    snap.labels.tolist(), snap.pairs,
                    (svc.stats.queries, svc.stats.microbatches,
                     svc.stats.admitted, svc.stats.duplicates_found)))
    assert out[0] == out[1]


@pytest.mark.parametrize("exact", [False, True])
def test_view_and_its_fingerprint_match_reference(exact):
    notes = _corpus(30, 15)
    view = _warm(notes, exact=exact, chunks=2)[0].view()
    ref_view = _warm(notes, exact=exact, chunks=2, ref=True)[0].view()
    assert view.version == ref_view.version == 1
    np.testing.assert_array_equal(view.labels, ref_view.labels)
    np.testing.assert_array_equal(view.signatures, ref_view.signatures)
    assert view.band_maps == ref_view.band_maps
    assert view.band_filters == ref_view.band_filters
    assert view.mode == ref_view.mode
    if exact:
        np.testing.assert_array_equal(view.exact.ids, ref_view.exact.ids)
        assert view.exact.vocab == ref_view.exact.vocab
    else:
        assert sanitize.view_fingerprint(view) == \
            ref_sanitize.view_fingerprint(ref_view)
    assert sanitize.view_fingerprint(ref_view) == \
        ref_sanitize.view_fingerprint(ref_view)


# -- query-after-ingest parity ---------------------------------------------------

@pytest.mark.parametrize("exact", [False, True])
def test_every_ingested_doc_queries_to_own_root_with_sim_one(exact):
    notes = _corpus()
    sess, snap = _warm(notes, exact=exact, chunks=3)
    results = DedupQueryService(sess).query(notes)
    assert len(results) == len(notes)
    for i, r in enumerate(results):
        assert r.is_duplicate, f"doc {i} not recognised"
        assert r.best_sim == 1.0
        assert r.cluster_root == int(snap.labels[i])


@pytest.mark.parametrize("exact", [False, True])
def test_candidate_sims_bit_identical_to_recorded_pairs(exact):
    notes = _corpus()
    sess, snap = _warm(notes, exact=exact, chunks=2)
    recorded = {(a, b): s for a, b, s in snap.pairs}
    overlap = 0
    for i, r in enumerate(DedupQueryService(sess).query(notes)):
        for doc, sim in r.candidates:
            key = (min(doc, i), max(doc, i))
            if key in recorded:
                overlap += 1
                assert np.float32(sim) == recorded[key], (i, doc)
    assert overlap > 0, "queries must re-evaluate recorded pairs"


def test_queries_never_mutate_session_state():
    notes = _corpus()
    sess, snap = _warm(notes, chunks=2)
    svc = DedupQueryService(sess)
    before = _session_state(sess)
    labels_before = snap.labels.copy()
    svc.query(notes)
    svc.query(["utterly novel content " * 20])
    for t in notes[:7]:
        svc.submit(t)
    svc.run_until_drained()
    assert _session_state(sess) == before
    np.testing.assert_array_equal(sess.snapshot().labels, labels_before)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_device_backends_match_numpy(backend):
    notes = _corpus(30, 20)
    sess, _ = _warm(notes, chunks=2)
    queries = notes[:9] + ["something else entirely " * 20]
    want = DedupQueryService(sess, backend="numpy").query(queries)
    svc = DedupQueryService(sess, backend=backend)
    assert svc.query(queries) == want
    assert svc.query(queries[:3]) == want[:3]  # the device buffer is reused


def test_probe_candidates_match_reference_and_read_nothing_else():
    notes = _corpus()
    sess, _ = _warm(notes, chunks=2)
    ref_sess, _ = _warm(notes, chunks=2, ref=True)
    view, ref_view = sess.view(), ref_sess.view()
    pipe = DedupPipeline(sess.config, device="cpu")
    _, bands = pipe.compute_arrays(pipe.tokenize(notes + ["novel " * 30]))
    # A row that hits through one band only.
    bands = np.concatenate([bands, bands[-1:]])
    bands[-1, 3] = bands[0, 3]
    order = [list(m) for m in sess.band_index._maps]
    got, hits = probe_candidates(view, bands)
    for min_batch in (1, 10**9):  # the reference's device probe and walk
        want, ref_hits = ref_query.probe_candidates(
            ref_view, bands, device_min_batch=min_batch)
        assert [c.tolist() for c in got] == [c.tolist() for c in want]
        assert hits == list(ref_hits)
    assert len(got[-2]) == 0 and set(got[-1].tolist()) >= {0}
    assert all(len(c) for c in got[:-2])
    # A pure read: no key inserted, no recency moved.
    assert [list(m) for m in sess.band_index._maps] == order


# -- SessionView publication protocol --------------------------------------------

def test_view_cached_until_mutation_and_versioned():
    notes = _corpus(30, 15)
    sess, _ = _warm(notes)
    v1 = sess.view()
    assert sess.view() is v1
    sess.ingest(notes[:5])
    v2 = sess.view()
    assert v2 is not v1 and v2.version == v1.version + 1
    assert v2.n_docs == v1.n_docs + 5


def test_old_view_answers_identically_after_interleaved_ingest():
    notes = _corpus()
    sess, _ = _warm(notes, chunks=2)
    view = sess.view()
    pipe = DedupPipeline(sess.config, device="cpu")
    pipe.seeds = sess.seeds
    sig, bands = pipe.compute_arrays(pipe.tokenize(notes[:10]))
    before = query_view(view, bands, sig=sig)
    sess.ingest([n + " trailing edit" for n in notes[:10]])
    sess.ingest(notes[:10])
    assert query_view(view, bands, sig=sig) == before
    assert query_view(sess.view(), bands, sig=sig) != before


def test_view_arrays_are_frozen():
    sess, _ = _warm(_corpus(20, 10))
    view = sess.view()
    with pytest.raises(ValueError):
        view.labels[0] = 99
    with pytest.raises(Exception):
        view.band_maps[0].popitem()[1].append(123)


def test_later_backends_have_no_session_to_view():
    """A streaming session keeps its state in its band store and has no
    view to publish, as the reference's (``test_query_service.py``)."""
    sess = DedupSession(DedupConfig(store="memory"), backend="streaming",
                        device="cpu")
    sess.ingest(_corpus(10, 5))
    with pytest.raises(ValueError, match="band store"):
        sess.view()


# -- retention: eviction and Bloom compaction ------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_query_after_eviction_finds_cluster_via_retained_root(backend):
    notes = _corpus(60, 40)
    sess, snap = _warm(notes, retention={"lru_window": 8}, chunks=6)
    ref_sess, _ = _warm(notes, retention={"lru_window": 8}, chunks=6,
                        ref=True)
    assert snap.evicted > 0, "test needs actual evictions"
    view = sess.view()
    assert view.slot_of is not None  # eviction layout reached
    assert view.slot_of == ref_sess.view().slot_of
    svc = DedupQueryService(sess, backend=backend)
    ref_svc = ref_core.DedupQueryService(ref_sess)
    evicted = [d for d in range(sess.n_docs) if d not in view.slot_of]
    assert evicted
    for d in evicted[:5]:
        got = svc.query([notes[d]])
        assert _values(got) == _values(ref_svc.query([notes[d]]))
        r = got[0]
        assert r.is_duplicate
        assert r.cluster_root == int(snap.labels[d])
        # The matched doc is retained (candidates were rewritten onto
        # roots at eviction).
        assert r.matched_doc in view.slot_of


def test_bloom_compacted_key_query_fallback():
    notes = _corpus(60, 10, seed=7)
    pol = {"lru_window": None, "band_key_budget": 4}
    sess, _ = _warm(notes, retention=pol, chunks=6)
    ref_sess, _ = _warm(notes, retention=pol, chunks=6, ref=True)
    assert sess.band_index.compacted_keys > 0
    svc = DedupQueryService(sess)
    counter_before = sess.band_index.filter_only_hits
    before = _session_state(sess)
    results = svc.query(notes)
    assert _values(results) == _values(
        ref_core.DedupQueryService(ref_sess).query(notes))
    # Early docs' keys were compacted into the per-band Bloom filters:
    # the query still learns "seen before, partner unnameable".
    assert sum(r.filter_only_hits for r in results) > 0
    # The session's own counter is untouched (a pure read).
    assert sess.band_index.filter_only_hits == counter_before
    assert _session_state(sess) == before


# -- service surface -------------------------------------------------------------

def test_admit_then_query_roundtrip():
    notes = _corpus(30, 15)
    sess, snap = _warm(notes)
    svc = DedupQueryService(sess)
    novel = "previously unseen admission note " * 10
    assert not svc.query([novel])[0].is_duplicate
    snap2 = svc.admit([novel])
    assert snap2.n_docs == snap.n_docs + 1
    r = svc.query([novel])[0]
    assert r.is_duplicate and r.best_sim == 1.0
    assert r.cluster_root == int(snap2.labels[snap.n_docs])
    assert svc.stats.admitted == snap2.n_docs


def test_public_api_surface():
    import repro_torch.core as core

    for name in ("DedupSession", "ClusterSnapshot", "SessionView",
                 "DedupConfig", "DistLSHConfig", "DedupQueryService",
                 "QueryResult", "query_view", "BandIndex", "DocIdAllocator"):
        assert hasattr(core, name), name
    from repro_torch.serving import DedupQueryService as via_serving
    from repro_torch.serving import QueryRequest, QueryServiceStats

    assert core.DedupQueryService is via_serving
    assert QueryRequest.__module__ == QueryServiceStats.__module__ == \
        "repro_torch.serving.dedup_service"
    assert core.RetentionPolicy.__module__ == "repro_torch.core.retention"
    with pytest.raises(AttributeError):
        core.StreamingDedup


def test_novel_query_result_shape():
    sess, _ = _warm(_corpus(20, 10))
    r = DedupQueryService(sess).query(["nothing like the corpus " * 15])[0]
    assert r == QueryResult(is_duplicate=False, cluster_root=None,
                            best_sim=0.0, matched_doc=None,
                            n_candidates=0, filter_only_hits=0,
                            candidates=())
    assert r.novel


def test_query_view_requires_matching_operands():
    sess, _ = _warm(_corpus(20, 10), exact=False)
    view = sess.view()
    pipe = DedupPipeline(sess.config, device="cpu")
    _, bands = pipe.compute_arrays(pipe.tokenize(["x " * 40]))
    with pytest.raises(ValueError, match="sig"):
        query_view(view, bands)  # an estimate view needs sig
    with pytest.raises(ValueError):
        query_view(view, np.zeros((1, 3, 2), np.uint32), sig=None)
    with pytest.raises(TypeError):
        query_view(view, bands.view(np.int32), sig=None)
    exact_view = _warm(_corpus(20, 10), exact=True)[0].view()
    with pytest.raises(ValueError, match="token_lists"):
        query_view(exact_view, bands)
    with pytest.raises(ValueError, match="estimate-mode"):
        DedupQueryService(_warm(_corpus(20, 10), exact=True)[0]).query_bytes(
            ["x"])


# -- REPRO_SANITIZE (tests/test_sanitize.py) -------------------------------------

def _sanitize_session():
    notes = [f"note alpha beta gamma delta {i} epsilon zeta eta theta"
             for i in range(12)]
    sess = DedupSession(DedupConfig(exact_verification=False), device="cpu")
    sess.ingest(notes)
    return sess, notes


def _query_arrays(sess, notes):
    pipe = sess._impl.pipe
    toks = pipe.tokenize([notes[0]])
    return pipe.compute_arrays(toks, pad_len=pow2_bucket(len(toks[0])))


def test_sanitize_disabled_by_default(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not sanitize.enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert not sanitize.enabled()


def test_view_tripwire_catches_in_place_mutation(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize.enabled()
    sess, notes = _sanitize_session()
    view = sess.view()
    sig, bands = _query_arrays(sess, notes)
    res = query_view(view, bands, sig=sig)[0]
    assert res.is_duplicate and res.best_sim == 1.0
    view.labels.setflags(write=True)
    try:
        view.labels[0] += 1
        with pytest.raises(sanitize.SessionViewMutated):
            query_view(view, bands, sig=sig)
        view.labels[0] -= 1
    finally:
        view.labels.setflags(write=False)
    assert query_view(view, bands, sig=sig)[0].is_duplicate


def test_view_tripwire_is_noop_when_disabled(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    sess, notes = _sanitize_session()
    view = sess.view()
    sig, bands = _query_arrays(sess, notes)
    view.labels.setflags(write=True)
    try:
        view.labels[0] += 1
        assert len(query_view(view, bands, sig=sig)) == 1
        view.labels[0] -= 1
    finally:
        view.labels.setflags(write=False)


def test_fingerprint_stable_and_content_sensitive():
    sess, _ = _sanitize_session()
    view = sess.view()
    fp = sanitize.view_fingerprint(view)
    assert sanitize.view_fingerprint(view) == fp
    sess2, _ = _sanitize_session()
    sess2.ingest(["an entirely different note about something else"])
    assert sanitize.view_fingerprint(sess2.view()) != fp
    view.labels.setflags(write=True)
    try:
        view.labels[0] += 1
        assert sanitize.view_fingerprint(view) != fp
        view.labels[0] -= 1
    finally:
        view.labels.setflags(write=False)
    assert sanitize.view_fingerprint(view) == fp
