"""Port parity of retention and the sqlite index over sharded steps.

A sharded ``DedupSession`` (``backend="sharded"``) with a
``RetentionPolicy`` sweeps between its band-group merges (the
``on_group_merged`` hook of ``dist_lsh.feed_step_groups``, the chunk's
own rows protected) and after each merge, and may keep its cross-step
index in sqlite (``DedupConfig(store="sqlite")``).  Every case runs the
port (``device="cpu"``, the kernels' plain versions) and ``repro`` on
the same notes and chunks, and holds each snapshot equal bit for bit:
labels, the (a, b, sim) list, the seven ``ClusterStats`` counters, the
five sharded counters, ``evicted``, ``retained_rows`` (the verifier's
live rows), ``filter_only_hits``, ``refine_merges`` and the
representatives.

In process, on one shard without a process group: the corpus of
``tests/test_retention.py:92`` and ``tests/test_bandstore_backends.py:105``
with stage 2 on the host and on the device, a sweep between band groups
that evicts, the overflow retry, ``refine`` and the ``small`` preset's
cadence, ``ingest_stream``, the sqlite index and ``query_view`` over its
view.  On four shards: ``tests/test_distributed.py:508``'s case through
the port in four spawned gloo processes and through the reference in one
subprocess with four forced JAX host devices, both started with the
module and run beside its in-process cases.
"""
import os
import time

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.dist_lsh as ref_dist
import repro.core.pipeline as ref_pipeline
import repro.core.session as ref_session
from tests.conftest import REPO
from tests.test_torch_sharded_session import COUNTERS, SHARDED

N_SHARDS = 4
RETAINED = ("evicted", "retained_rows", "filter_only_hits", "refine_merges")


def record(snap) -> dict:
    """A ``ClusterSnapshot`` as plain values, to compare across packages."""
    return {"n_docs": snap.n_docs, "labels": snap.labels.tolist(),
            "pairs": snap.pairs,
            "stats": [getattr(snap.stats, f) for f in COUNTERS],
            "sharded": [getattr(snap, f) for f in SHARDED],
            "retained": [getattr(snap, f) for f in RETAINED],
            "representatives": (None if snap.representatives is None
                                else snap.representatives.tolist())}


def _policy(**kw):
    """The port's ``RetentionPolicy`` (imported here: the reference's
    subprocess imports this module and no torch)."""
    from repro_torch.core import RetentionPolicy

    return RetentionPolicy(**kw)


def _ref_policy(policy):
    """The reference's ``RetentionPolicy`` with the port policy's fields."""
    if policy is None:
        return None
    return ref_core.RetentionPolicy(
        lru_window=policy.lru_window, band_key_budget=policy.band_key_budget,
        bloom_bits=policy.bloom_bits, bloom_hashes=policy.bloom_hashes,
        refine_every=policy.refine_every)


@pytest.fixture(scope="module")
def ref_steps():
    """The reference's compiled sharded steps by step config, shared by
    this module's reference sessions: a step is a function of its config
    and mesh alone, and each new one would compile again."""
    return {}


def _sessions(policy, dist_kw: dict, cfg_kw: dict, steps: dict, *,
              store="memory", paths=(":memory:", ":memory:"),
              use_kernels=False):
    """(port session, reference session): sharded, one shard, the same
    configs and policy; each over its own store path.  The reference
    session takes its step from ``steps`` (``ref_steps``)."""
    from repro_torch.core import DedupConfig, DedupSession, dist_lsh

    cfg = dict(cfg_kw, exact_verification=False, store=store)
    port = DedupSession(
        DedupConfig(verify_backend="kernel", use_kernels=use_kernels, **cfg),
        backend="sharded", dist_config=dist_lsh.DistLSHConfig(**dist_kw),
        retention=policy, store_path=paths[0], device="cpu")
    ref = ref_session.DedupSession(
        ref_pipeline.DedupConfig(**cfg), backend="sharded",
        dist_config=ref_dist.DistLSHConfig(**dist_kw),
        retention=_ref_policy(policy), store_path=paths[1])
    key = tuple(sorted(dist_kw.items()))
    if key not in steps:
        steps[key] = ref._impl._get_step()
    ref._impl._step = steps[key]
    return port, ref


def _assert_same(port, ref, snap, ref_snap):
    assert record(snap) == record(ref_snap)
    assert port.band_index.stats() == ref.band_index.stats()
    assert port.refines_run == ref.refines_run
    assert port.verifier.n_live_rows == snap.retained_rows


def _ingest_both(port, ref, chunks):
    for c in chunks:
        snap, ref_snap = port.ingest(c), ref.ingest(c)
        _assert_same(port, ref, snap, ref_snap)
    return snap


def _append_only(dist_kw: dict, cfg_kw: dict, chunks):
    """The port's sharded session without a policy: the outcome that
    eviction must leave as it is."""
    from repro_torch.core import DedupConfig, DedupSession, dist_lsh

    sess = DedupSession(
        DedupConfig(verify_backend="kernel", exact_verification=False,
                    store="memory", **cfg_kw),
        backend="sharded", dist_config=dist_lsh.DistLSHConfig(**dist_kw),
        device="cpu")
    for c in chunks:
        snap = sess.ingest(c)
    return snap


def _chunks(notes, k):
    return [[notes[i] for i in idx]
            for idx in np.array_split(np.arange(len(notes)), k)]


def _random_docs(n=32, seed=0, size=48):
    """``n`` docs of ``size`` tokens from a vocabulary of 300.  Docs of
    one length pack to one shape, so the reference compiles its step
    once for every chunk of a size."""
    rng = np.random.RandomState(seed)
    vocab = [f"t{i}" for i in range(300)]
    return [" ".join(rng.choice(vocab, size=size)) for _ in range(n)]


def _small_docs():
    """``tests/test_retention.py:92``'s corpus: 32 random docs, doc 3
    copied to docs 5 and 21 (a cross-chunk duplicate), doc 11 to 29."""
    docs = _random_docs()
    docs[5] = docs[3]
    docs[21] = docs[3]
    docs[29] = docs[11]
    return docs


SMALL_CFG = dict(ngram=4, num_hashes=20, edge_threshold=0.5)


def _small_dist(stage2: str, **kw) -> dict:
    return dict(dict(ngram=4, num_hashes=20, verify_k=8, edge_capacity=256,
                     edge_threshold=0.5, bucket_slack=16.0, band_groups=2,
                     stage2=stage2), **kw)


def _copied_docs():
    """32 random docs: 22 of their own and copies of 10 of the first 16,
    permuted, so that copies land in other chunks than their sources and
    in the same chunk as each other.  In 4 chunks of 8 they pack to the
    shape of ``_small_docs``'s chunks, so the reference's steps compiled
    for those serve these too."""
    docs = _random_docs(22, seed=8)
    rng = np.random.RandomState(9)
    docs += [docs[i] for i in rng.choice(16, size=10, replace=False)]
    return [docs[i] for i in rng.permutation(len(docs))]


# -- one shard, in process -----------------------------------------------------

@pytest.mark.parametrize("stage2", ["host", "device"])
def test_one_shard_evicted_session_matches_reference(stage2, ref_steps):
    """``tests/test_retention.py:92`` on the port: under an LRU window of
    6 the sharded session equals the reference's snapshot for snapshot
    and the port's append-only session in labels and pairs; rows are
    evicted, and device stage 2 re-scores nothing on the host."""
    chunks = _chunks(_small_docs(), 4)
    dist_kw = _small_dist(stage2)
    port, ref = _sessions(_policy(lru_window=6), dist_kw, SMALL_CFG, ref_steps)
    snap = _ingest_both(port, ref, chunks)
    plain = _append_only(dist_kw, SMALL_CFG, chunks)
    np.testing.assert_array_equal(snap.labels, plain.labels)
    assert snap.pairs == plain.pairs
    assert snap.evicted > 0 and snap.overflow == 0
    assert snap.retained_rows == snap.n_docs - snap.evicted
    assert snap.representatives.tolist() == sorted(
        {int(r) for r in snap.labels})
    if stage2 == "device":
        assert snap.device_scored > 0 and snap.host_rescored == 0


def _in_step_docs():
    """32 random docs in 4 chunks of 8 with duplicates that unions settle
    inside a chunk's last ids: doc 7 copies doc 6 (chunk 0's window),
    doc 14 copies doc 15 (chunk 1's), doc 22 copies doc 2 across chunks,
    and doc 30 copies doc 23.  Under a window of 4 each deposed doc of
    chunks 0 and 1 is older than the cutoff only once the next chunk's
    merge has begun, so the first sweep between its band groups is what
    evicts it."""
    docs = _random_docs(seed=5)
    docs[7] = docs[6]
    docs[14] = docs[15]
    docs[22] = docs[2]
    docs[30] = docs[23]
    return docs


def _count_in_step(sess, log: list) -> None:
    """Wrap the session's sweep: each sweep between band groups (the one
    that passes ``protect_from``) appends what it evicted to ``log``."""
    inner = sess.retention.sweep

    def sweep(s, protect_from=None):
        n = inner(s, protect_from=protect_from)
        if protect_from is not None:
            log.append((s.n_merged, protect_from, n))
        return n

    sess.retention.sweep = sweep


@pytest.mark.parametrize("stage2", ["host", "device"])
def test_sweep_between_band_groups_evicts_as_the_reference(stage2, ref_steps):
    """The sweeps between band groups run once a group, with the chunk's
    base as the bound, and are the ones that evict the previous chunk's
    window: the port's evict what the reference's evict, sweep by sweep,
    and the outcome equals the append-only session's."""
    chunks = _chunks(_in_step_docs(), 4)
    dist_kw = _small_dist(stage2)
    port, ref = _sessions(_policy(lru_window=4), dist_kw, SMALL_CFG, ref_steps)
    logs = ([], [])
    _count_in_step(port, logs[0])
    _count_in_step(ref, logs[1])
    snap = _ingest_both(port, ref, chunks)
    assert logs[0] == logs[1]
    assert len(logs[0]) == len(chunks) * dist_kw["band_groups"]
    assert all(bound == n_merged - 8 for n_merged, bound, _ in logs[0])
    assert sum(n for *_, n in logs[0]) >= 2
    plain = _append_only(dist_kw, SMALL_CFG, chunks)
    np.testing.assert_array_equal(snap.labels, plain.labels)
    assert snap.pairs == plain.pairs
    assert snap.labels[6] == snap.labels[7]
    assert snap.labels[14] == snap.labels[15]
    if stage2 == "device":
        assert snap.device_scored > 0 and snap.host_rescored == 0


def test_overflow_retry_with_retention_matches_reference(ref_steps):
    """Edge buffers of 4 overflow, the retry re-derives each chunk's
    candidates after its groups' sweeps, and nothing it needs was
    evicted: the session equals the reference's and the append-only
    session's partition, with rows evicted."""
    chunks = _chunks(_copied_docs(), 4)
    dist_kw = _small_dist("device", edge_capacity=4)
    port, ref = _sessions(_policy(lru_window=10), dist_kw, SMALL_CFG,
                          ref_steps)
    snap = _ingest_both(port, ref, chunks)
    assert snap.overflow > 0 and snap.retried > 0
    assert snap.evicted > 0
    plain = _append_only(dist_kw, SMALL_CFG, chunks)
    np.testing.assert_array_equal(snap.labels, plain.labels)


@pytest.mark.parametrize("budget", ["small", "tight"])
def test_small_preset_refine_cadence_matches_reference(budget, ref_steps):
    """``RetentionPolicy.preset("small", refine_every=2)``, and a tighter
    policy whose window and key budget fit these 32 docs, refining every
    2 steps (K5's plain version folds the representatives) over 4
    chunks: equal to the reference after every chunk, with the roots'
    rows re-adopted by the host-edge verifier after mid-step sweeps, and
    the representatives equal; the tight policy evicts rows, compacts
    keys and merges in its refines."""
    from repro_torch.core import RetentionPolicy

    chunks = _chunks(_copied_docs(), 4)
    policy = (RetentionPolicy.preset("small", refine_every=2)
              if budget == "small" else
              RetentionPolicy(lru_window=8, band_key_budget=16,
                              bloom_bits=1 << 12, refine_every=2))
    port, ref = _sessions(policy, _small_dist("device"), SMALL_CFG,
                          ref_steps, use_kernels=True)
    snap = _ingest_both(port, ref, chunks)
    assert port.refines_run == 2
    if budget == "tight":
        assert snap.evicted > 0 and port.band_index.compacted_keys > 0
        assert snap.refine_merges > 0
    assert port.retention.representatives() == \
        ref.retention.representatives()
    assert snap.host_rescored == 0


def test_refine_on_a_sharded_session_merges_as_the_reference(ref_steps):
    """``refine()`` by hand at a lower threshold, on a sharded session
    under retention with device stage 2: the second round merges the
    two clusters (K2's and K5's plain versions) and sweeps the deposed
    root, as the reference's does."""
    from dataclasses import replace

    rng = np.random.RandomState(4)
    vocab = [f"t{i}" for i in range(120)]
    base_doc = list(rng.choice(vocab, size=60))
    near = list(base_doc)
    near[30] = "zz"
    docs = [" ".join(base_doc), " ".join(base_doc), " ".join(near),
            " ".join(near)] + _random_docs(8, seed=6, size=60)
    cfg_kw = dict(edge_threshold=0.9, tree_threshold=0.1)
    dist_kw = dict(edge_capacity=256, edge_threshold=0.9, bucket_slack=16.0,
                   band_groups=2, stage2="device")
    port, ref = _sessions(_policy(lru_window=0), dist_kw, cfg_kw, ref_steps,
                          use_kernels=True)
    snap = _ingest_both(port, ref, [docs[:6], docs[6:]])
    assert snap.labels[0] == snap.labels[1] != snap.labels[2]
    port.config = replace(port.config, edge_threshold=0.45)
    ref.config = replace(ref.config, edge_threshold=0.45)
    snap = port.refine()
    _assert_same(port, ref, snap, ref.refine())
    assert snap.refine_merges >= 1 and snap.labels[0] == snap.labels[2]
    assert snap.evicted > 0
    assert port.stage_timings["refine_pairs"] > 0


def test_ingest_stream_with_retention_equals_sequential_ingest(ref_steps):
    """The lookahead dispatches chunk t+1 (its ids allocated) before chunk
    t merges; the sweeps take their cutoff from the merged docs, so the
    stream equals sequential ``ingest`` and the reference's stream."""
    chunks = _chunks(_in_step_docs(), 4)
    dist_kw = _small_dist("device")
    port, ref = _sessions(_policy(lru_window=4), dist_kw, SMALL_CFG, ref_steps)
    streamed = [record(s) for s in port.ingest_stream(chunks)]
    assert streamed == [record(s) for s in ref.ingest_stream(chunks)]
    seq, _ = _sessions(_policy(lru_window=4), dist_kw, SMALL_CFG, ref_steps)
    assert streamed == [record(seq.ingest(c)) for c in chunks]
    assert streamed[-1]["retained"][0] > 0


@pytest.mark.parametrize("stream", [True, False, None])
def test_feed_step_groups_calls_its_hook_once_a_group(stream):
    """``on_group_merged`` runs once after each group's feed, in every
    ``stream`` mode, and the feed is the one without the hook."""
    from repro_torch.core import dist_lsh, minhash, shingle
    from repro_torch.core.engine import ClusterAccumulator
    from repro_torch.core.verify import DeviceScoredEdgeVerifier

    docs = _small_docs()
    packed = shingle.pack_documents([shingle.tokenize(t) for t in docs])
    cfg = dist_lsh.DistLSHConfig(**_small_dist("device", band_groups=5))
    out = dist_lsh.make_streamed_dedup_step(cfg, dist_lsh.docs_mesh("cpu"))(
        packed.tokens, packed.lengths, minhash.default_seeds(20))
    feeds = []
    for hook in (False, True):
        v = DeviceScoredEdgeVerifier(out["sig"], backend="kernel",
                                     device="cpu")
        acc = ClusterAccumulator(len(docs), v, cfg.edge_threshold, 0.4)
        seen = []
        feed = dist_lsh.feed_step_groups(
            acc, out, cfg, num_docs=len(docs), verifier=v, stream=stream,
            on_group_merged=(lambda: seen.append(acc.stats.pairs_evaluated))
            if hook else None)
        feeds.append((feed.num_edges, feed.overflow,
                      feed.device_stats.tolist(),
                      [[getattr(s, f) for f in COUNTERS]
                       for s in feed.group_stats],
                      acc.pairs, v.n_passthrough, v.n_rescored))
        if hook:
            # Once a group, after that group's feed.
            assert len(seen) == cfg.band_groups
            assert seen == list(np.cumsum(
                [s.pairs_evaluated for s in feed.group_stats]))
    assert feeds[0] == feeds[1]
    assert feeds[0][0] > 0


# -- the sqlite index over sharded steps -----------------------------------------

@pytest.mark.parametrize("stage2", ["host", "device"])
def test_sqlite_sharded_session_matches_reference_and_memory(stage2,
                                                            tmp_path,
                                                            ref_steps):
    """``tests/test_bandstore_backends.py:105`` on the port: a sharded
    session under an LRU window of 6 with its cross-step index in sqlite
    equals the reference's sqlite session and the port's memory one,
    with rows evicted; its view publishes the live store."""
    from repro_torch.core.bandstore import SqliteBandStore

    chunks = _chunks(_small_docs(), 4)
    dist_kw = _small_dist(stage2)
    port, ref = _sessions(
        _policy(lru_window=6), dist_kw, SMALL_CFG, ref_steps, store="sqlite",
        paths=(str(tmp_path / "port.db"), str(tmp_path / "ref.db")))
    snap = _ingest_both(port, ref, chunks)
    mem, _ = _sessions(_policy(lru_window=6), dist_kw, SMALL_CFG, ref_steps)
    for c in chunks:
        mem_snap = mem.ingest(c)
    assert record(snap) == record(mem_snap)
    assert port.band_index.compacted_keys == mem.band_index.compacted_keys
    assert snap.evicted == mem_snap.evicted > 0
    assert isinstance(port.band_index, SqliteBandStore)
    view = port.view()
    assert view.band_store is port.band_index and view.band_maps == ()
    assert (tmp_path / "port.db").stat().st_size > 0


def _result(r) -> tuple:
    return (r.is_duplicate, r.cluster_root, r.best_sim, r.matched_doc,
            r.n_candidates, r.filter_only_hits, r.candidates)


@pytest.fixture(scope="module")
def sqlite_views(tmp_path_factory, ref_steps):
    """(the port's sqlite session, its memory twin, the reference's sqlite
    session, the queries' signatures and bands): ``_small_docs`` in 4
    chunks under a window of 6 and a key budget of 8, so keys are
    compacted.  The queries are every doc and a novel one, their arrays
    made once by the port for both packages' ``query_view``."""
    from repro_torch.core import DedupConfig, DedupPipeline, RetentionPolicy

    tmp = tmp_path_factory.mktemp("sqlite_views")
    docs = _small_docs()
    chunks = _chunks(docs, 4)
    policy = RetentionPolicy(lru_window=6, band_key_budget=8,
                             bloom_bits=1 << 12)
    dist_kw = _small_dist("device")
    disk, ref = _sessions(
        policy, dist_kw, SMALL_CFG, ref_steps, store="sqlite",
        paths=(str(tmp / "port.db"), str(tmp / "ref.db")))
    _ingest_both(disk, ref, chunks)
    mem, _ = _sessions(policy, dist_kw, SMALL_CFG, ref_steps)
    for c in chunks:
        mem.ingest(c)
    assert disk.band_index.compacted_keys > 0
    queries = docs + ["an entirely novel note text " * 6]
    pipe = DedupPipeline(DedupConfig(exact_verification=False, **SMALL_CFG),
                         device="cpu")
    sig, bands = pipe.compute_arrays(pipe.tokenize(queries))
    return disk, mem, ref, sig, bands


@pytest.mark.parametrize("batch", [3, 33])
def test_query_view_over_a_sqlite_sharded_view(batch, sqlite_views):
    """``tests/test_bandstore_backends.py:129`` over sharded sessions: the
    sqlite view's Bloom-first probe answers as the memory view's dict
    walk and as the reference's sqlite view, at a small and a large
    batch, compacted keys included."""
    from repro.core.query import query_view as ref_query_view
    from repro_torch.core.query import query_view

    disk, mem, ref, sig, bands = sqlite_views
    got = query_view(disk.view(), bands[:batch], sig=sig[:batch],
                     backend="kernel")
    assert got == query_view(mem.view(), bands[:batch], sig=sig[:batch])
    want = ref_query_view(ref.view(), bands[:batch], sig=sig[:batch])
    assert [_result(r) for r in got] == [_result(r) for r in want]
    # The first docs' keys were compacted: they hit the filters only.
    assert sum(r.filter_only_hits for r in got) > 0
    if batch == len(bands):     # every doc, then the novel note
        assert any(r.is_duplicate for r in got) and got[-1].novel


# -- four shards ---------------------------------------------------------------

# tests/test_distributed.py:508: 56 notes and 8 near-duplicates,
# permuted, in 2 chunks, under an LRU window of 8.  Buffers of 256 edges
# hold every prescreened edge of these steps (checked: overflow == 0).
FOUR_CFG = dict(edge_threshold=0.88)
FOUR_DIST = dict(edge_capacity=256, edge_threshold=0.88, bucket_slack=16.0,
                 band_groups=2)
# name, stage2, store, LRU window (None: append-only, the port alone).
FOUR_CASES = [("lru8_host", "host", "memory", 8),
              ("lru8_device", "device", "memory", 8),
              ("lru8_device_sqlite", "device", "sqlite", 8)]
PORT_ONLY = [("append_only", "host", "memory", None)]


def four_rank_corpus(data) -> list[str]:
    notes = data.make_i2b2_like(56, seed=0)
    notes, _ = data.inject_near_duplicates(notes, 8, frac_low=0.0,
                                           frac_high=0.005, seed=1)
    order = np.random.RandomState(2).permutation(len(notes))
    return [notes[i] for i in order]


def run_four_rank_cases(session_cls, dist_cls, config_cls, policy_cls, data,
                        cases, store_dir: str, tag: str,
                        **session_kw) -> dict:
    """Every case through ``session_cls`` (the reference's or the port's,
    with ``DistLSHConfig``, ``DedupConfig``, ``RetentionPolicy`` and
    ``data`` of the same package), each sqlite index a file
    ``{tag}_{name}.db`` in ``store_dir``; the last snapshot's record.
    Imports no torch, so the reference's subprocess does not pay for
    it."""
    notes = four_rank_corpus(data)
    chunks = [[notes[i] for i in idx]
              for idx in np.array_split(np.arange(len(notes)), 2)]
    out, steps = {}, {}
    for name, stage2, store, window in cases:
        cfg = config_cls(exact_verification=False, store=store, **FOUR_CFG)
        sess = session_cls(
            cfg, backend="sharded",
            dist_config=dist_cls(stage2=stage2, **FOUR_DIST),
            retention=None if window is None else policy_cls(
                lru_window=window),
            store_path=os.path.join(store_dir, f"{tag}_{name}.db"),
            **session_kw)
        # One compiled step a stage-2 mode (it depends on nothing else).
        if stage2 not in steps:
            steps[stage2] = sess._impl._get_step()
        sess._impl._step = steps[stage2]
        for snap in sess.ingest_stream(chunks):
            pass
        out[name] = record(snap)
    return out


def _port_worker(rank: int, init_file: str, out_dir: str) -> None:
    import pickle

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=N_SHARDS)
    try:
        from repro_torch import data
        from repro_torch.core import DedupConfig, DedupSession, RetentionPolicy
        from repro_torch.core.dist_lsh import DistLSHConfig

        out = run_four_rank_cases(
            DedupSession, DistLSHConfig,
            lambda **kw: DedupConfig(verify_backend="kernel", **kw),
            RetentionPolicy, data, FOUR_CASES + PORT_ONLY, out_dir,
            f"port{rank}", device="cpu")
        with open(os.path.join(out_dir, f"port{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


REFERENCE = """
    import pickle, sys
    sys.path.insert(0, {repo!r})
    import jax
    assert jax.device_count() == {n}
    from repro import data
    from repro.core import DedupConfig, DedupSession, RetentionPolicy
    from repro.core.dist_lsh import DistLSHConfig
    from tests.test_torch_sharded_retention import (FOUR_CASES,
                                                    run_four_rank_cases)
    out = run_four_rank_cases(DedupSession, DistLSHConfig, DedupConfig,
                              RetentionPolicy, data, FOUR_CASES, {tmp!r},
                              "ref")
    with open({out!r}, "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def four_shard_runs(tmp_path_factory):
    """The four gloo processes and the reference's subprocess;
    ``four_shards`` waits for them.  Both are ended on the way out."""
    import subprocess
    import sys
    import textwrap

    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("sharded_retention")
    workers = mp.start_processes(
        _port_worker, args=(str(tmp / "pg_init"), str(tmp)),
        nprocs=N_SHARDS, join=False, start_method="spawn")
    env = dict(os.environ, XLA_FLAGS=(
        f"--xla_force_host_platform_device_count={N_SHARDS}"))
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    ref_path = str(tmp / "ref.pkl")
    code = REFERENCE.format(repo=REPO, n=N_SHARDS, tmp=str(tmp),
                            out=ref_path)
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    runs = {"tmp": tmp, "workers": workers, "ref": ref,
            "ref_path": ref_path}
    yield runs
    if ref.poll() is None:
        ref.kill()
    ref.communicate()
    for proc in workers.processes:
        if proc.is_alive():
            proc.kill()
        proc.join()


@pytest.fixture(scope="module", autouse=True)
def _start_four_shards_with_module(request):
    """Starts ``four_shard_runs`` when the module starts, so that its
    processes run beside the in-process tests, but only where a
    four-rank test of this module was selected: a selection without one
    starts nothing."""
    if any(getattr(item, "module", None) is request.module
           and "four_rank" in item.name for item in request.session.items):
        request.getfixturevalue("four_shard_runs")


@pytest.fixture(scope="module")
def four_shards(four_shard_runs):
    """(every rank's records, the reference's), once both runs end."""
    import pickle

    tmp, workers = four_shard_runs["tmp"], four_shard_runs["workers"]
    ref = four_shard_runs["ref"]
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, (
        f"the reference's subprocess failed:\nSTDOUT:\n{out}\n"
        f"STDERR:\n{err[-4000:]}")
    deadline = time.monotonic() + 300
    while not workers.join(timeout=5):
        if time.monotonic() > deadline:
            raise TimeoutError("the four gloo processes did not end")
    ranks = []
    for r in range(N_SHARDS):
        with open(tmp / f"port{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(four_shard_runs["ref_path"], "rb") as f:
        ref_records = pickle.load(f)
    return ranks, ref_records


@pytest.mark.parametrize("name", [c[0] for c in FOUR_CASES])
def test_four_rank_retention_matches_reference(four_shards, name):
    """Every rank's last snapshot equals the reference's on four devices:
    labels, pairs and sims, every counter, the retained state."""
    ranks, ref = four_shards
    for rank, port in enumerate(ranks):
        assert port[name] == ref[name], rank


def test_four_rank_retention_contracts(four_shards):
    """What ``tests/test_distributed.py:508`` pins, on the port's rank 0:
    nothing overflows, rows are evicted, eviction leaves the append-only
    outcome as it was, and device stage 2 scores on the device and
    re-scores nothing on the host; the sqlite index equals the memory
    one."""
    port = four_shards[0][0]
    plain = port["append_only"]
    for name, stage2, _, _ in FOUR_CASES:
        rec = port[name]
        sharded = dict(zip(SHARDED, rec["sharded"]))
        assert sharded["overflow"] == sharded["row_overflow"] == 0, name
        assert rec["retained"][0] > 0, name
        assert rec["labels"] == plain["labels"], name
        assert rec["pairs"] == plain["pairs"], name
        if stage2 == "device":
            assert sharded["device_scored"] > 0, name
            assert sharded["host_rescored"] == 0, name
    assert port["lru8_device_sqlite"] == port["lru8_device"]
