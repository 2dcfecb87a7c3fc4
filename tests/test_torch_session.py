"""Port parity of the host ``DedupSession`` and its growth primitives.

Each case runs ``repro_torch``'s session (``device="cpu"``, the kernels'
plain versions) and ``repro``'s on the same seeded corpus and chunks,
and holds labels, ``n_docs``, the ``ClusterStats`` counters and the
(a, b, sim) list equal bit for bit.  Mirrors the host cases of
``tests/test_session.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.pipeline as ref_pipeline
import repro.core.session as ref_session
import repro.core.verify as ref_verify
from repro.data import inject_near_duplicates, make_i2b2_like
from repro_torch.core.pipeline import DedupConfig, DedupPipeline
from repro_torch.core.session import BandIndex, DedupSession, DocIdAllocator
from repro_torch.core.verify import ExactJaccardVerifier, SignatureVerifier

# ClusterStats counters (verify_seconds is a wall time).
COUNTERS = ("pairs_generated", "pairs_evaluated", "pairs_excluded",
            "pairs_above_edge", "unions_done", "unions_rejected",
            "verify_batches")


def _corpus(n=40, dups=25, seed=0):
    notes = make_i2b2_like(n, seed=seed)
    notes, _ = inject_near_duplicates(notes, dups, seed=seed + 1)
    return notes


def _chunks(notes, k):
    return [[notes[i] for i in idx]
            for idx in np.array_split(np.arange(len(notes)), k)]


def _configs(port_overrides=None, **ref_fields):
    """(reference DedupConfig, the port's DedupConfig of the same fields).

    The reference side always verifies with numpy: its Pallas and jnp
    estimates are 1 ulp off the numpy estimator for some counts, while
    the port's three backends equal it (ROADMAP.md, caveats)."""
    ref_cfg = ref_pipeline.DedupConfig(store="memory", **ref_fields)
    fields = {**dataclasses.asdict(ref_cfg), **(port_overrides or {})}
    port = DedupPipeline.from_reference(fields, np.zeros(ref_cfg.num_hashes,
                                                         np.uint32),
                                        device="cpu").config
    return ref_cfg, port


def _assert_same(got, want):
    assert got.n_docs == want.n_docs
    np.testing.assert_array_equal(got.labels, want.labels)
    for f in COUNTERS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.pairs == want.pairs
    assert got.retained_rows == want.retained_rows


def _both(ref_cfg, cfg, chunks, **kw):
    ref = ref_session.DedupSession(ref_cfg, backend="host", **kw)
    port = DedupSession(cfg, device="cpu", **kw)
    assert np.array_equal(port.seeds, ref.seeds)
    for chunk in chunks:
        want = ref.ingest(chunk)
        got = port.ingest(chunk)
        _assert_same(got, want)
    return port, ref, got, want


# -- sessions against the reference ----------------------------------------------

@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_host_session_matches_reference_and_one_shot(exact, n_chunks):
    notes = _corpus()
    ref_cfg, cfg = _configs(exact_verification=exact)
    port, _, snap, _ = _both(ref_cfg, cfg, _chunks(notes, n_chunks))
    assert port.steps_ingested == n_chunks
    # The port's chunked session against its own one-shot run, as the
    # reference's test holds its session: labels, and the sim of every
    # pair both evaluate.
    one_shot = DedupPipeline(cfg, device="cpu").run(notes)
    np.testing.assert_array_equal(snap.labels, one_shot.labels)
    sims = {(a, b): s for a, b, s in one_shot.pairs}
    shared = [(a, b, s) for a, b, s in snap.pairs if (a, b) in sims]
    assert shared and all(s == sims[(a, b)] for a, b, s in shared)
    assert snap.num_duplicates == one_shot.num_duplicates_removed
    assert snap.num_clusters == one_shot.num_clusters
    if exact:
        assert port.signatures.shape == (0, cfg.num_hashes)
    else:
        np.testing.assert_array_equal(port.signatures, one_shot.signatures)


# (reference fields, port overrides) of each ingest path, estimate mode.
INGEST_PATHS = {
    "plain": (dict(), {}),
    "staged_kernels": (dict(use_pallas=True, verify_backend="numpy"),
                       dict(verify_backend="kernel")),
    "fused": (dict(fused_ingest=True), dict(verify_backend="torch")),
    "byte": (dict(byte_ingest=True), dict(verify_backend="kernel")),
}


@pytest.mark.parametrize("path", list(INGEST_PATHS))
def test_ingest_paths_match_reference(path):
    ref_fields, overrides = INGEST_PATHS[path]
    ref_cfg, cfg = _configs(overrides, exact_verification=False,
                            verify_batch="band", **ref_fields)
    port, ref, _, _ = _both(ref_cfg, cfg, _chunks(_corpus(30, 20, seed=4), 3))
    np.testing.assert_array_equal(port.signatures, ref.signatures)


@pytest.mark.parametrize("exact", [True, False])
def test_doc_id_base_resumed_ingest_matches_reference(exact):
    notes = _corpus(30, 20, seed=13)
    ref_cfg, cfg = _configs(exact_verification=exact)
    _, _, snap, _ = _both(ref_cfg, cfg, [notes[:15], notes[15:] + [notes[0]]],
                          doc_id_base=100)
    assert snap.n_docs == 100 + len(notes) + 1
    assert (snap.labels[:100] == np.arange(100)).all()  # gap singletons


@pytest.mark.parametrize("doc_id_base", [0, 100])
def test_device_verifier_grows_from_the_chunks_device_rows(doc_id_base):
    notes = _corpus(30, 20, seed=13)
    ref_cfg, cfg = _configs(dict(verify_backend="kernel"),
                            exact_verification=False, fused_ingest=True)
    port, ref, _, _ = _both(ref_cfg, cfg, _chunks(notes, 3),
                            doc_id_base=doc_id_base)
    # The chunks' signatures never went through the host.
    assert port.verifier._host is None and port.verifier._dev is not None
    np.testing.assert_array_equal(port.signatures, ref.signatures)


def test_ingest_stream_equals_sequential_ingest_and_reference():
    notes = _corpus(40, 20, seed=5)
    ref_cfg, cfg = _configs(exact_verification=False)
    chunks = _chunks(notes, 4)
    seq = DedupSession(cfg, device="cpu")
    seq_snaps = [seq.ingest(c) for c in chunks]
    stream = DedupSession(cfg, device="cpu")
    stream_snaps = list(stream.ingest_stream(chunks))
    ref_snaps = list(ref_session.DedupSession(
        ref_cfg, backend="host").ingest_stream(chunks))
    assert len(stream_snaps) == len(seq_snaps) == len(ref_snaps)
    for a, b, c in zip(seq_snaps, stream_snaps, ref_snaps):
        assert a.n_docs == b.n_docs
        np.testing.assert_array_equal(a.labels, b.labels)
        _assert_same(b, c)
    assert seq_snaps[-1].pairs == stream_snaps[-1].pairs


def test_ingest_tokens_and_empty_chunks_match_reference():
    notes = _corpus(30, 15, seed=6)
    ref_cfg, cfg = _configs(exact_verification=False)
    ref = ref_session.DedupSession(ref_cfg, backend="host")
    port = DedupSession(cfg, device="cpu")
    toks = port._impl.pipe.tokenize(notes)
    for chunk in (toks[:12], [], toks[12:]):
        _assert_same(port.ingest_tokens(chunk), ref.ingest_tokens(chunk))
    assert port.steps_ingested == ref.steps_ingested == 2


def test_snapshots_are_cumulative_and_isolated():
    notes = _corpus(40, 20, seed=3)
    sess = DedupSession(DedupConfig(exact_verification=False), device="cpu")
    snap1 = sess.ingest(notes[:20])
    snap2 = sess.ingest(notes[20:])
    assert snap2.n_docs == len(notes) > snap1.n_docs
    assert snap2.stats.pairs_evaluated >= snap1.stats.pairs_evaluated
    before, pairs_before = snap1.stats.pairs_evaluated, list(snap1.pairs)
    sess.ingest(notes[:5])
    assert snap1.stats.pairs_evaluated == before
    assert snap1.pairs == pairs_before
    with pytest.raises(ValueError):
        snap1.labels[0] = 7
    assert {"merge_s", "cross_step_s", "cross_step_edges", "labels_s",
            "pairs_s"} <= set(sess.stage_timings)
    assert sess.stage_timings["cross_step_edges"] > 0


def test_merge_precomputed_finalizes_the_session():
    notes = _corpus(20, 10, seed=8)
    cfg = DedupConfig(exact_verification=False)
    sess = DedupSession(cfg, device="cpu")
    pipe = sess._impl.pipe
    toks = pipe.tokenize(notes)
    sig, bands = pipe.compute_arrays(toks)
    snap = sess._merge_precomputed(toks, sig, bands)
    assert snap.n_docs == len(notes) and sess.steps_ingested == 1
    # No cross-step index for a one-shot chunk.
    assert sess.band_index.stats()["n_keys"] == 0
    with pytest.raises(ValueError, match="finalized"):
        sess.ingest(notes)
    with pytest.raises(ValueError, match="finalized"):
        sess._merge_precomputed(toks, sig, bands)
    want = DedupPipeline(cfg, device="cpu").run(notes)
    np.testing.assert_array_equal(snap.labels, want.labels)
    assert snap.pairs == want.pairs


def test_pipeline_run_through_the_session_keeps_its_result():
    notes = _corpus(30, 15, seed=10)
    ref_cfg, cfg = _configs(exact_verification=False, fused_ingest=True)
    ref_pipe = ref_pipeline.DedupPipeline(ref_cfg)
    want = ref_pipe.run(notes)
    got = DedupPipeline(cfg, device="cpu").run(notes)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.keep_mask, want.keep_mask)
    assert got.pairs == want.pairs
    for f in COUNTERS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert set(got.timings) == {
        "tokenize_s", "pack_s", "upload_s", "ingest_s", "download_s",
        "signatures_s", "verifier_build_s", "cluster_s", "verify_s",
        "labels_s", "pairs_s"}
    assert not got.labels.flags.writeable


def test_later_slices_raise_not_implemented(tmp_path):
    """The slices this test once waited for are ported: a sharded session
    with a retention policy, and one over the sqlite index, are built
    and equal the reference's (``tests/test_torch_sharded_retention.py``
    has the rest); the streaming backend and ``over_store`` equal the
    reference's (``tests/test_torch_streaming.py`` has the rest), as do
    retention, ``refine`` and the bounded ``BandIndex``
    (``tests/test_torch_retention.py``)."""
    import repro.core.dist_lsh as ref_dist
    from repro.core import RetentionPolicy as RefPolicy
    from repro_torch.core import RetentionPolicy, dist_lsh
    from repro_torch.core.bandstore import SqliteBandStore
    from repro_torch.core.streaming import StreamingDedup
    import repro.core.streaming as ref_streaming

    docs = _corpus(24, 12, seed=2)
    fields = dict(ngram=4, num_hashes=20, edge_threshold=0.5,
                  exact_verification=False)
    dk = dict(ngram=4, num_hashes=20, verify_k=8, edge_capacity=256,
              edge_threshold=0.5, bucket_slack=16.0, band_groups=2)
    step = None  # the reference's compiled step, shared by its sessions
    for store, window in (("memory", 8), ("sqlite", None)):
        path = str(tmp_path / f"{store}.db")
        port = DedupSession(
            DedupConfig(verify_backend="kernel", store=store, **fields),
            device="cpu", backend="sharded", store_path=path,
            dist_config=dist_lsh.DistLSHConfig(**dk),
            retention=RetentionPolicy(lru_window=window) if window else None)
        ref = ref_session.DedupSession(
            ref_pipeline.DedupConfig(store=store, **fields),
            backend="sharded", store_path=str(tmp_path / f"ref_{store}.db"),
            dist_config=ref_dist.DistLSHConfig(**dk),
            retention=RefPolicy(lru_window=window) if window else None)
        step = ref._impl._step = step or ref._impl._get_step()
        assert port.backend == "sharded"
        assert isinstance(port.band_index, SqliteBandStore) \
            == (store == "sqlite")
        for chunk in _chunks(docs, 2):
            got, want = port.ingest(chunk), ref.ingest(chunk)
            _assert_same(got, want)
            assert got.evicted == want.evicted
    cfg = DedupConfig(store="memory")
    notes = _corpus(24, 12, seed=2)
    ref_cfg, port_cfg = _configs(exact_verification=False)
    ref = ref_session.DedupSession(ref_cfg, backend="streaming", chunk_docs=8)
    port = DedupSession(port_cfg, backend="streaming", chunk_docs=8,
                        device="cpu")
    for chunk in _chunks(notes, 2):
        _assert_same(port.ingest(chunk), ref.ingest(chunk))
    sd = StreamingDedup(port_cfg, chunk_docs=8, device="cpu")
    ref_sd = ref_streaming.StreamingDedup(ref_cfg, chunk_docs=8)
    sd.ingest(notes)
    ref_sd.ingest(notes)
    _assert_same(DedupSession.over_store(sd).snapshot(),
                 ref_session.DedupSession.over_store(ref_sd).snapshot())
    assert BandIndex(4, key_budget=8).stats()["bloom_bytes"] == 0
    assert DedupSession(cfg, device="cpu").refine().refine_merges == 0
    with pytest.raises(ValueError):
        DedupSession(cfg, backend="nope", device="cpu")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DedupSession(DedupConfig())


# -- growth primitives -----------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch", "kernel"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_signature_verifier_extension_matches_full_build(backend, as_tensor):
    rng = np.random.RandomState(2)
    sig = rng.randint(0, 50, size=(30, 100)).astype(np.uint32)
    sig[3, :] = 2**32 - 1  # words with the top bit set
    pairs = np.array([(a, b) for a in range(0, 30, 3)
                      for b in range(a + 1, 30, 7)], dtype=np.int64)
    want = ref_verify.SignatureVerifier(sig)(pairs)

    def rows(a):
        return torch.from_numpy(a.view(np.int32)) if as_tensor else a

    v = SignatureVerifier(rows(sig[:10]), backend=backend, device="cpu")
    v(pairs[pairs.max(axis=1) < 10])  # make the device copy, then grow it
    v.extend_signatures(rows(sig[10:20]))
    v.extend_signatures(rows(sig[20:]))
    np.testing.assert_array_equal(v(pairs), want)
    np.testing.assert_array_equal(v.signatures, sig)
    np.testing.assert_array_equal(v.rows_for([4, 29]), sig[[4, 29]])
    frozen, slot_of = v.frozen_rows()
    assert slot_of is None and v.n_live_rows == 30
    v.extend_signatures(sig[:3])  # later rows leave the frozen ones alone
    np.testing.assert_array_equal(frozen, sig)
    if backend != "numpy":
        dev = v._device_signatures()
        assert dev.is_contiguous() and dev.shape == (33, 100)
    with pytest.raises(ValueError):
        v.extend_signatures(np.zeros((2, 7), dtype=np.uint32))


def test_exact_verifier_extension_matches_full_build_and_reference():
    notes = _corpus(30, 15, seed=9)
    toks = [n.split() for n in notes]
    toks[12] = toks[12] * 3  # a longer row later pads the whole matrix again
    pairs = np.array([(a, b) for a in range(0, 30, 3)
                      for b in range(a + 1, 30, 7)], dtype=np.int64)
    full = ExactJaccardVerifier.from_token_lists(toks, 8)
    v = ExactJaccardVerifier.from_token_lists(toks[:10], 8)
    ref = ref_verify.ExactJaccardVerifier.from_token_lists(toks[:10], 8)
    for s in (slice(10, 20), slice(20, None)):
        v.extend_token_lists(toks[s])
        ref.extend_token_lists(toks[s])
    np.testing.assert_array_equal(v(pairs), full(pairs))
    np.testing.assert_array_equal(v(pairs), ref(pairs))
    np.testing.assert_array_equal(v.ids, ref.ids)
    np.testing.assert_array_equal(v.lengths, ref.lengths)
    assert v._vocab == ref._vocab
    ids, lengths, slot_of = v.frozen_rows()
    assert slot_of is None and ids is v.ids and v.n_live_rows == len(toks)
    raw = ExactJaccardVerifier([np.array([1, 2, 3])])
    with pytest.raises(ValueError):
        raw.extend_token_lists([["a"]])  # no vocab to intern with
    sets = [{("a", "b")}, {("b", "c")}]
    ext = ExactJaccardVerifier.from_ngram_sets(sets, n=2)
    ext.extend_token_lists([["a", "b", "c"]])
    np.testing.assert_array_equal(ext(np.array([[0, 2], [1, 2]])),
                                  np.float32([0.5, 0.5]))


def test_doc_id_allocator_matches_reference():
    al, ref = DocIdAllocator(100), ref_session.DocIdAllocator(100)
    assert al.allocate(8) == ref.allocate(8) == 100
    assert al.allocate(4) == ref.allocate(4) == 108
    assert al.n_docs == ref.n_docs == 112
    got = DocIdAllocator.device_offsets(108, 2, 4)
    np.testing.assert_array_equal(got, np.uint32([108, 110, 112, 114]))
    np.testing.assert_array_equal(
        got, ref_session.DocIdAllocator.device_offsets(108, 2, 4))
    assert got.dtype == np.uint32


def test_band_index_matches_reference():
    rng = np.random.RandomState(11)
    idx, ref = BandIndex(3), ref_session.BandIndex(3)
    base = 0
    for c in (6, 5, 7):
        # Few distinct values and the top lane bit set: collisions across
        # and within chunks, keys that a signed word would make negative.
        bands = (rng.randint(0, 3, size=(c, 3, 2)).astype(np.uint32)
                 | np.uint32(0x80000000))
        got = idx.match_then_insert(bands, base)
        np.testing.assert_array_equal(got, ref.match_then_insert(bands, base))
        base += c
    assert idx.export_maps() == ref.export_maps()
    assert list(idx.export_maps()[0]) == list(ref.export_maps()[0])  # LRU order
    assert idx.export_filters() == ref.export_filters() == (None,) * 3
    assert idx.stats() == ref.stats()
    # The reference's hand-made case: same-chunk collisions are not emitted.
    idx = BandIndex(2)
    b1 = np.array([[[1, 1], [9, 9]], [[2, 2], [8, 8]]], dtype=np.uint32)
    assert len(idx.match_then_insert(b1, 0)) == 0
    b2 = np.array([[[1, 1], [8, 8]], [[1, 1], [7, 7]]], dtype=np.uint32)
    assert sorted(map(tuple, idx.match_then_insert(b2, 2).tolist())) == \
        [(0, 2), (0, 3), (1, 2)]
    with pytest.raises(ValueError):
        idx.match_then_insert(np.zeros((1, 3, 2), np.uint32), 9)
    with pytest.raises(TypeError):
        idx.match_then_insert(np.zeros((1, 2, 2), np.int32), 9)
