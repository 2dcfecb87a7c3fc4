"""Incremental multi-step ingest: ``DedupSession``.

Port of the host and streaming backends of ``repro.core.session``.
``DedupSession`` owns the long-lived clustering state of a corpus that
arrives in chunks:

* one ``engine.ClusterAccumulator`` (union-find, verified-sim cache,
  cumulative ``ClusterStats``);
* global doc-id allocation (``DocIdAllocator``);
* the retained per-doc rows, in one growing verifier (signature rows in
  estimate mode, interned n-gram id rows in exact mode);
* a retained band index for cross-step candidates: the in-RAM
  ``BandIndex``, or with ``DedupConfig(store="sqlite")`` a
  ``bandstore.SqliteBandStore`` at ``store_path`` (the same API on
  disk, behind Bloom-first lookups).

Each chunk contributes two candidate families: its own band matrix
(``candidates.BandMatrixSource``), and the band collisions of its band
values against the retained index, which become explicit edges
(``candidates.ShardedEdgeSource``) verified through the same engine.
Over N chunks the candidate-pair set equals the one-shot run's; only the
feed order differs.

The streaming backend (``backend="streaming"``) writes each chunk into
a Design-2 band store through ``core.streaming.StreamingDedup`` (phase
1) and then re-scans the whole store band-major through the accumulator
(phase 2); the verified-sim cache keeps a pair from being verified
twice.  The store is its retained state: it keeps no ``BandIndex``
entries and publishes no ``SessionView``.  Under ``store="sqlite"`` the
store is a ``SqliteBandStore`` that also holds the signature rows, and
the session verifies off disk through ``DiskSignatureVerifier`` (K2').
``over_store`` adopts an already-populated ``StreamingDedup``.

The read path publishes an immutable ``SessionView``
(``DedupSession.view``), which ``core.query`` and
``serving.dedup_service.DedupQueryService`` serve.

The sharded backend (``backend="sharded"``) runs one
``dist_lsh.make_streamed_dedup_step`` call a chunk, with global doc ids
from the allocator, over a ``dist_lsh.DocsMesh`` (one process a card;
every rank runs the same session on the gathered step outputs), and
feeds the step's band-group edge buffers into the accumulator through
``dist_lsh.feed_step_groups``; with ``stage2="device"`` the step's own
scores register with the session's ``DeviceScoredEdgeVerifier``.  An
overflowed step is re-derived on the host from its signatures (the
retry), before the chunk's cross-step pass.

A ``retention.RetentionPolicy`` bounds the retained state: each merge
is followed by a sweep that evicts the rows of docs that lost roothood
(outside an LRU window) and rewrites their band-index entries onto
their roots, and the index compacts its oldest keys into per-band Bloom
filters past a key budget.  ``refine`` is the paper's §10 second
clustering round over the cluster representatives.

The session's stages run on its ``device`` (``"cuda"`` unless told):
signatures and bands through the ``DedupPipeline`` stages (K1, K3 and
K4, or K6 with byte ingest), the kernel verify backend through K2, and
``refine``'s re-band of the representatives through K5 when
``config.use_kernels`` is on, and a sqlite streaming session's verify
through K2'.  A sharded session runs the step's K1 (or K6 -> K1), K7 for
``stage2="device"``, and K2 for every host verify.  Under a retention
policy it also sweeps between the step's band-group merges, with the
chunk's own rows protected, and its cross-step index may be the sqlite
one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from itertools import islice
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.core import lsh, minhash, shingle
from repro_torch.core.bandstore import SqliteBandStore
from repro_torch.core.candidates import BandMatrixSource, ShardedEdgeSource
from repro_torch.core.engine import (
    ClusterAccumulator,
    ClusterStats,
    merge_cluster_rounds,
)
from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy
from repro_torch.core.pipeline import DedupConfig
from repro_torch.core.retention import (
    BandBloomFilter,
    RetentionManager,
    RetentionPolicy,
)
from repro_torch.core.unionfind import ThresholdUnionFind
from repro_torch.core.verify import (
    BatchVerifier,
    DeviceScoredEdgeVerifier,
    ExactJaccardVerifier,
    SignatureVerifier,
    as_verifier,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import bandfold

BACKENDS = ("host", "streaming", "sharded")


class DocIdAllocator:
    """Global doc-id allocation for chunked ingest.

    ``allocate(n)`` hands out the next contiguous block and returns its
    base; ``device_offsets(base, d_loc, n_dev)`` is the sharded step's
    per-device ``doc_offsets`` (device i's first row is
    ``base + i * d_loc``).
    """

    def __init__(self, base: int = 0):
        self.base = int(base)
        self.next = int(base)

    @property
    def n_docs(self) -> int:
        """Exclusive upper bound of allocated ids (gap ids included)."""
        return self.next

    def allocate(self, n: int) -> int:
        base = self.next
        self.next += int(n)
        return base

    @staticmethod
    def device_offsets(base: int, d_loc: int, n_dev: int) -> np.ndarray:
        return np.uint32(base) + np.uint32(d_loc) * np.arange(
            n_dev, dtype=np.uint32)


class BandIndex:
    """Retained band values of every ingested doc, keyed for collision.

    ``match_then_insert`` is the cross-step candidate generator: each
    (band, value) of the chunk that hits a doc of an EARLIER chunk emits
    an (old_doc, new_doc) edge, and then the chunk's values are
    inserted.  Same-chunk collisions are never emitted (the chunk's band
    matrix owns those).  Keys are ``(hi, lo)`` Python ints of the uint32
    band lanes.

    Bounded form: with ``track_entries`` the index keeps a per-doc map
    of its (band, key) entries, so ``evict`` can rewrite an evicted
    doc's entries onto its cluster root; ``key_budget`` caps the keys of
    a band by compacting the least recently hit ones into the band's
    ``BandBloomFilter``.  A later new key found in the filter counts one
    ``filter_only_hits``: seen before, by a doc the index cannot name.
    """

    def __init__(self, num_bands: int, *, key_budget: int | None = None,
                 bloom_bits: int = 1 << 17, bloom_hashes: int = 4,
                 track_entries: bool = False):
        self._maps: list[dict[tuple[int, int], list[int]]] = [
            {} for _ in range(num_bands)]
        self._key_budget = key_budget
        self._bloom_bits = int(bloom_bits)
        self._bloom_hashes = int(bloom_hashes)
        self._filters: list[BandBloomFilter | None] = [None] * num_bands
        self._entries: dict[int, list] | None = (
            {} if track_entries else None)
        self.filter_only_hits = 0
        self.compacted_keys = 0

    @property
    def num_bands(self) -> int:
        return len(self._maps)

    def _filter(self, j: int) -> BandBloomFilter:
        if self._filters[j] is None:
            self._filters[j] = BandBloomFilter(self._bloom_bits,
                                               self._bloom_hashes)
        return self._filters[j]

    def match_then_insert(self, bands: np.ndarray,
                          doc_id_base: int) -> np.ndarray:
        """(C, b, 2) uint32 chunk bands -> (E, 2) int64 cross-step edges."""
        bands = np.asarray(bands)
        if bands.ndim != 3 or bands.shape[1] != self.num_bands:
            raise ValueError(
                f"expected (C, {self.num_bands}, 2) bands, got {bands.shape}")
        if bands.dtype != np.uint32:
            raise TypeError(f"expected uint32 band values, got {bands.dtype}")
        edges: list[tuple[int, int]] = []
        entries = self._entries
        for j, m in enumerate(self._maps):
            # A band's filter changes only at its compaction, after the
            # walk, so the walk's filter hits are read in one batch.
            flt = self._filters[j]
            in_filter = (flt.contains_keys(bands[:, j, :])
                         if flt is not None else None)
            for i, (hi, lo) in enumerate(bands[:, j, :].tolist()):
                key = (hi, lo)
                new_id = doc_id_base + i
                olds = m.get(key)
                if olds is not None:
                    edges.extend((old, new_id) for old in olds
                                 if old < doc_id_base)
                    olds.append(new_id)
                    # Refresh recency: compaction pops from the front of
                    # the dict, so a key hit every chunk is never
                    # compacted.
                    m[key] = m.pop(key)
                else:
                    if in_filter is not None and in_filter[i]:
                        self.filter_only_hits += 1
                    m[key] = [new_id]
                if entries is not None:
                    entries.setdefault(new_id, []).append((j, key))
            if self._key_budget is not None and len(m) > self._key_budget:
                old_keys = list(islice(m, len(m) - self._key_budget))
                for k in old_keys:
                    del m[k]
                self._filter(j).add_keys(np.array(old_keys, dtype=np.uint32))
                self.compacted_keys += len(old_keys)
        if not edges:
            return np.zeros((0, 2), dtype=np.int64)
        return np.array(edges, dtype=np.int64)

    def evict(self, doc_ids, root_of) -> None:
        """Rewrite evicted docs' bucket entries onto their cluster root.

        ``root_of`` maps a doc id to its current union-find root.  The
        root inherits the evicted doc's (band, key) entries (moved in the
        per-doc map, so a later eviction of a deposed root still works)
        and enters each bucket at most once.
        """
        if self._entries is None:
            raise ValueError(
                "BandIndex was built without track_entries; eviction "
                "needs the per-doc reverse map")
        for d in doc_ids:
            d = int(d)
            for j, key in self._entries.pop(d, ()):
                olds = self._maps[j].get(key)
                if olds is None:
                    continue               # key already compacted
                try:
                    olds.remove(d)
                except ValueError:
                    continue               # key was compacted and seen again
                r = int(root_of(d))
                if r not in olds:
                    olds.append(r)
                    self._entries.setdefault(r, []).append((j, key))

    def export_maps(self) -> tuple:
        """Per-band ``{(hi, lo): (doc ids,)}`` copies for a ``SessionView``,
        bucket lists frozen to tuples.  A pure read: no recency moves."""
        return tuple({k: tuple(v) for k, v in m.items()} for m in self._maps)

    def export_filters(self) -> tuple:
        """Per-band Bloom filter copies for a ``SessionView`` (``None`` for
        a band that compacted nothing)."""
        return tuple(f.copy() if f is not None else None
                     for f in self._filters)

    def published(self) -> tuple:
        """What a ``SessionView`` holds of the index: its band maps and
        filters, copied, and no live store."""
        return self.export_maps(), self.export_filters(), None

    def stats(self) -> dict:
        """Memory and recall accounting."""
        return {
            "n_keys": sum(len(m) for m in self._maps),
            "n_entries": sum(len(v) for m in self._maps for v in m.values()),
            "n_docs_tracked": (len(self._entries)
                               if self._entries is not None else 0),
            "compacted_keys": self.compacted_keys,
            "filter_only_hits": self.filter_only_hits,
            "bloom_bytes": sum(f.memory_bytes for f in self._filters
                               if f is not None),
        }


@dataclass(frozen=True)
class ClusterSnapshot:
    """Cluster state after an ``ingest`` call: a value object.

    ``labels`` is a read-only copy, ``stats`` a counter copy and
    ``pairs`` a fresh list, so later ingests never change a snapshot.
    """

    n_docs: int                 # docs ingested so far (id upper bound)
    labels: np.ndarray          # (n_docs,) cluster root per doc (frozen)
    stats: ClusterStats         # cumulative engine counters (a copy)
    pairs: list                 # every evaluated (a, b, sim) so far (a copy)
    overflow: int = 0           # sharded: device buffer overflow so far
    retried: int = 0            # sharded: overflow retries run
    device_scored: int = 0      # sharded stage2=device: pass-throughs
    host_rescored: int = 0      # sharded stage2=device: host re-scores
    row_overflow: int = 0       # sharded: cross-shard row-buffer overflow
    # Retained state (sessions with a retention policy):
    retained_rows: int = 0      # live verifier rows (== n_docs unevicted)
    evicted: int = 0            # rows released by the retention policy
    filter_only_hits: int = 0   # band hits whose partner was compacted
    refine_merges: int = 0      # second-round merges so far
    representatives: np.ndarray | None = None  # retained roots (sorted)

    @property
    def num_clusters(self) -> int:
        """Duplicate clusters, i.e. components of size >= 2."""
        _, counts = np.unique(self.labels, return_counts=True)
        return int((counts >= 2).sum())

    @property
    def num_duplicates(self) -> int:
        """Docs that are non-representative members of some cluster."""
        return self.n_docs - len(set(self.labels.tolist()))

    def clusters(self, min_size: int = 2) -> list[list[int]]:
        groups: dict[int, list[int]] = {}
        for i, r in enumerate(self.labels):
            groups.setdefault(int(r), []).append(i)
        return [v for v in groups.values() if len(v) >= min_size]


@dataclass(frozen=True)
class ExactRowsView:
    """Frozen exact-verifier rows inside a ``SessionView``.

    ``vocab`` is the live verifier's, shared by reference: interning is
    append-only, so a read path that only ``get``s from it stays valid
    across later ingests.
    """

    ids: np.ndarray             # (R, lmax) padded sorted n-gram id rows
    lengths: np.ndarray         # (R,) real row lengths
    slot_of: dict | None        # doc -> row (eviction layout; None = id)
    vocab: dict                 # n-gram -> id (append-only, shared)
    ngram: int

    def row_for(self, doc: int) -> np.ndarray:
        slot = doc if self.slot_of is None else self.slot_of[doc]
        return self.ids[slot][: int(self.lengths[slot])]


@dataclass(frozen=True)
class SessionView:
    """Immutable read-path handle over a ``DedupSession``.

    Published by one attribute swap on the session when a read follows a
    mutation.  Everything a query touches is a frozen copy (labels, band
    maps) or an append-only buffer whose visible rows are never
    rewritten (the retained signature or token rows), so a query holding
    a view cannot race a later ingest.

    In the eviction layout (a retention policy evicted a row) the rows
    and the doc -> row map are copies taken at publication.  ``device``
    is the session's: the read path's device verify runs there.

    A session under ``store="sqlite"`` publishes its live
    ``SqliteBandStore`` as ``band_store`` instead of exporting the disk
    index into host dicts (``band_maps`` and ``band_filters`` are then
    empty): the probe goes through the store's pure Bloom-first
    ``probe_keys``.  Its answers reflect the store at query time, so a
    view held across later ingests can see newer entries; the probe
    clips them to the view's ``n_docs``.
    """

    version: int                # monotone publication counter
    n_docs: int                 # docs covered (labels bound)
    edge_threshold: float       # the engine's duplicate threshold
    num_bands: int
    rows_per_band: int
    labels: np.ndarray          # (n_docs,) cluster root per doc (frozen)
    band_maps: tuple            # per band: {(hi, lo): (doc ids,)}
    band_filters: tuple         # per band: BandBloomFilter | None
    signatures: np.ndarray      # retained rows (estimate sessions)
    slot_of: dict | None        # doc -> signature row (eviction layout)
    exact: ExactRowsView | None = None   # exact-verification sessions
    band_store: SqliteBandStore | None = None
    device: torch.device = field(default=torch.device("cpu"), compare=False)

    @property
    def mode(self) -> str:
        return "exact" if self.exact is not None else "estimate"

    def root_of(self, doc: int) -> int:
        return int(self.labels[doc])

    def slot_index(self, ids: np.ndarray) -> np.ndarray:
        """Global doc ids -> physical signature rows."""
        ids = np.asarray(ids, dtype=np.int64)
        if self.slot_of is None:
            return ids
        so = self.slot_of
        return np.fromiter((so[int(i)] for i in ids.ravel()), dtype=np.int64,
                           count=ids.size).reshape(ids.shape)

    def rows_for(self, doc_ids) -> np.ndarray:
        """Retained signature rows for ``doc_ids`` at publication time."""
        ids = np.asarray(doc_ids, dtype=np.int64)
        if ids.size == 0:
            return np.zeros((0,) + self.signatures.shape[1:],
                            dtype=self.signatures.dtype)
        return self.signatures[self.slot_index(ids)]


class DedupSession:
    """Long-lived incremental dedup over the host, streaming or sharded
    backend.

    ``ingest(chunk)`` clusters one chunk of documents into the session
    and returns a cumulative ``ClusterSnapshot``; ``ingest_stream``
    dispatches chunk t+1 before merging chunk t.

    * ``"host"``: an in-memory band matrix per chunk plus the cross-step
      ``BandIndex``; verification is exact Jaccard or the signature
      estimate per ``config.exact_verification``, as in
      ``DedupPipeline``.
    * ``"streaming"``: chunks go into a Design-2 band store
      (``store_path``, flushed every ``chunk_docs`` documents) and each
      merge re-scans the store; verification is the signature estimate
      unless ``verifier`` is given.
    * ``"sharded"``: one sharded step a chunk (``dist_config``, a
      ``dist_lsh.DistLSHConfig`` whose hash parameters must equal
      ``config``'s; ``mesh``, default ``dist_lsh.docs_mesh(device)``),
      its band groups fed into the accumulator (``stream``: see
      ``dist_lsh.feed_step_groups``), then the cross-step ``BandIndex``
      pass; verification is the signature estimate.

    ``device`` (``"cuda"`` unless told; raises without a CUDA device
    unless ``"cpu"`` is passed) is where the pipeline stages and the
    device verify backends run.

    ``retention`` (a ``RetentionPolicy``) bounds the retained rows and
    band keys; ``refine`` runs the second clustering round, by hand or
    every ``retention.refine_every`` steps.
    """

    def __init__(
        self,
        config: DedupConfig | None = None,
        backend: str = "host",
        *,
        dist_config=None,
        mesh=None,
        store_path: str = ":memory:",
        chunk_docs: int = 512,
        doc_id_base: int = 0,
        verifier: BatchVerifier | None = None,
        stream: bool | None = None,
        retention: RetentionPolicy | None = None,
        device="cuda",
        _adopt_streaming=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.config = config or DedupConfig()
        self.backend = backend
        self.device = resolve_device(device)
        self.allocator = DocIdAllocator(doc_id_base)
        self._verifier = as_verifier(verifier) if verifier is not None \
            else None
        self._external_verifier = verifier is not None
        self._est_verifier: SignatureVerifier | None = None
        self.acc = ClusterAccumulator(
            int(doc_id_base), _NullVerifier(), self.config.edge_threshold,
            self.config.tree_threshold,
            use_disjoint_sets=self.config.use_disjoint_sets,
            batch=self.config.verify_batch)
        self.retention = (RetentionManager(retention)
                          if retention is not None else None)
        if self.retention is not None:
            # Each union logs the root it deposed, so a sweep never scans
            # every doc for lost roothood.
            self.acc.uf.track_deposed = True
        # The cross-step index: the in-RAM BandIndex, or under "sqlite"
        # the same API on disk at store_path.  The streaming backend's
        # retained state is its band store, so its (unused) index stays
        # in memory.
        index_kw = {}
        index_cls = BandIndex
        if self.config.store == "sqlite" and backend != "streaming":
            index_cls, index_kw = SqliteBandStore, {"path": store_path}
        self.band_index = index_cls(
            num_bands=self.config.num_bands,
            key_budget=(retention.band_key_budget
                        if retention is not None else None),
            bloom_bits=(retention.bloom_bits if retention is not None
                        else 1 << 17),
            bloom_hashes=(retention.bloom_hashes if retention is not None
                          else 4),
            track_entries=retention is not None, **index_kw)
        self.seeds = minhash.default_seeds(self.config.num_hashes)
        self.overflow = 0
        self.retried = 0
        self.row_overflow = 0
        self.steps_ingested = 0
        self.refine_merges = 0
        self.refines_run = 0
        # Docs whose merge has completed; snapshots cover these.  With
        # ingest_stream's lookahead the allocator runs one chunk ahead.
        self.n_merged = int(doc_id_base)
        self._finalized = False
        # Wall times and counts of the last merge and snapshot:
        # ``merge_s`` (retain, the chunk's band matrix, the cross-step
        # pass), ``cross_step_s`` (BandIndex.match_then_insert and the
        # verify of its edges), ``cross_step_edges``, the retention
        # sweep's ``sweep_s``, a sharded merge's ``feed_s`` (its band
        # groups, waiting for the step included), the last refine's
        # ``refine_s``, ``refine_band_s`` (re-band and bucket walk),
        # ``refine_pairs`` and ``refine_merges``, and the snapshot's
        # ``labels_s`` and ``pairs_s``.
        self.stage_timings: dict[str, float] = {}
        # Read-path publication state (SessionView).
        self._view_cache: SessionView | None = None
        self._view_key = None
        self._view_version = 0
        if backend == "host":
            self._impl = _HostBackend(self)
        elif backend == "streaming":
            self._impl = _StreamingBackend(self, store_path=store_path,
                                           chunk_docs=chunk_docs,
                                           adopt=_adopt_streaming)
        else:
            self._impl = _ShardedBackend(self, dist_config=dist_config,
                                         mesh=mesh, stream=stream)

    @classmethod
    def over_store(cls, sd, *, config: DedupConfig | None = None,
                   verifier: BatchVerifier | None = None) -> "DedupSession":
        """Adopt an already-populated ``StreamingDedup`` (store and
        signature cache) and cluster its contents as one step.

        The adapter behind ``StreamingDedup.cluster``; the session runs
        on ``sd.device`` and stays live: later ``ingest`` calls append
        to the same store and union-find.  ``sd.n_docs`` may exceed the
        contiguous allocation (resumed-ingest gaps); gap ids have no
        store rows, so they stay singletons.
        """
        sess = cls(config=config or sd.config, backend="streaming",
                   verifier=verifier, device=sd.device,
                   _adopt_streaming=sd)
        sess.allocator.next = sd.n_docs
        sess.n_merged = sd.n_docs
        if verifier is None and sd.n_ingested:
            # The full (n_docs, M) global-id matrix, gap rows zero: row i
            # stays doc i for the adopted docs and for later ingests.
            sess._verifier = sd.default_verifier()
        sess.acc.grow(sd.n_docs)
        sess.acc.feed(sd.candidate_source(), verifier=sess._verifier)
        sess.steps_ingested += 1
        return sess

    # -- state -------------------------------------------------------------

    @property
    def n_docs(self) -> int:
        """Docs fully ingested (merged) so far: snapshot coverage."""
        return self.n_merged

    @property
    def stats(self) -> ClusterStats:
        return self.acc.stats

    @property
    def uf(self) -> ThresholdUnionFind:
        return self.acc.uf

    @property
    def verifier(self) -> BatchVerifier | None:
        return self._verifier

    @property
    def signatures(self) -> np.ndarray:
        """The retained (D, M) uint32 signature matrix, row i == doc i
        until the retention policy evicts a row (``verifier.rows_for`` is
        the eviction-aware accessor).

        Owned by the session's verifier; empty for exact-mode or
        external-verifier sessions, which do not verify by signatures.
        """
        sig = getattr(self._verifier, "signatures", None)
        if sig is None:
            return np.zeros((0, self.config.num_hashes), dtype=np.uint32)
        return sig

    def snapshot(self) -> ClusterSnapshot:
        """The cumulative cluster state as a value object.  Records
        ``labels_s`` and ``pairs_s`` (building each copy) in
        ``stage_timings``."""
        v = self._verifier
        retained = getattr(v, "n_live_rows", None)
        t0 = time.perf_counter()
        labels = self.uf.components()[: self.n_docs]
        labels.setflags(write=False)
        t1 = time.perf_counter()
        pairs = self.acc.pairs
        self.stage_timings.update(labels_s=t1 - t0,
                                  pairs_s=time.perf_counter() - t1)
        return ClusterSnapshot(
            n_docs=self.n_docs,
            labels=labels,
            stats=replace(self.acc.stats),
            pairs=pairs,
            overflow=self.overflow,
            retried=self.retried,
            device_scored=getattr(v, "n_passthrough", 0),
            host_rescored=getattr(v, "n_rescored", 0),
            row_overflow=self.row_overflow,
            retained_rows=retained if retained is not None else self.n_docs,
            evicted=(self.retention.n_evicted
                     if self.retention is not None else 0),
            filter_only_hits=self.band_index.filter_only_hits,
            refine_merges=self.refine_merges,
            representatives=(np.array(self.retention.representatives(),
                                      dtype=np.int64)
                             if self.retention is not None else None),
        )

    # -- read path (SessionView publication) ---------------------------------

    def _view_state_key(self) -> tuple:
        """Covers every mutation that can change a view's contents."""
        return (self.steps_ingested, self.n_merged, self.refines_run,
                self.acc.stats.unions_done,
                self.retention.n_evicted if self.retention is not None
                else 0,
                self.band_index.compacted_keys)

    def view(self) -> SessionView:
        """The current immutable read-path handle over this session.

        Built on the first read after a mutation and cached: the same
        object comes back until the session changes.  A query holding an
        older view keeps getting the same answers after later ingests.
        A streaming session raises ``ValueError``: its retained state is
        its band store, with no cross-step ``BandIndex`` to probe.
        """
        if self.backend == "streaming":
            raise ValueError(
                "SessionView needs a backend that maintains the "
                "cross-step BandIndex (host or sharded); the streaming "
                "backend's retained state is its band store")
        key = self._view_state_key()
        if self._view_cache is not None and self._view_key == key:
            return self._view_cache
        labels = self.uf.components()[: self.n_docs]
        labels.setflags(write=False)
        cfg = self.config
        v = self._verifier
        exact = None
        sig = np.zeros((0, cfg.num_hashes), dtype=np.uint32)
        slot_of = None
        if isinstance(v, ExactJaccardVerifier):
            if v._vocab is None or v._ngram is None:
                raise ValueError(
                    "exact verifier was built from raw id rows (no "
                    "vocab/ngram); the read path cannot intern query "
                    "documents; build it with from_token_lists")
            ids, lengths, slot = v.frozen_rows()
            exact = ExactRowsView(ids=ids, lengths=lengths, slot_of=slot,
                                  vocab=v._vocab, ngram=v._ngram)
        elif isinstance(v, SignatureVerifier):
            sig, slot_of = v.frozen_rows()
        elif v is not None and self.n_docs > self.allocator.base:
            raise ValueError(
                "SessionView needs retained signature or token rows; "
                "external callback verifiers keep neither; pass a "
                "SignatureVerifier/ExactJaccardVerifier instead")
        band_maps, band_filters, band_store = self.band_index.published()
        view = SessionView(
            version=self._view_version + 1,
            n_docs=self.n_docs,
            edge_threshold=cfg.edge_threshold,
            num_bands=cfg.num_bands,
            rows_per_band=cfg.rows_per_band,
            labels=labels,
            band_maps=band_maps,
            band_filters=band_filters,
            signatures=sig,
            slot_of=slot_of,
            exact=exact,
            band_store=band_store,
            device=self.device,
        )
        # The one sanctioned read-path mutation: this cache swap IS the
        # atomic single-writer publication (same key, same object);
        # queries never observe a half-built view.
        # repro-lint: disable=RPR002
        self._view_version = view.version
        self._view_cache, self._view_key = view, key  # repro-lint: disable=RPR002
        return view

    # -- ingest ------------------------------------------------------------

    def _check_live(self):
        if self._finalized:
            raise ValueError(
                "this session was finalized by a one-shot ingest "
                "(DedupPipeline.run adapter) and skipped the cross-step "
                "index; start a fresh DedupSession for chunked ingest")

    def ingest(self, texts: Iterable[str]) -> ClusterSnapshot:
        """Cluster one chunk of documents; returns a cumulative snapshot."""
        self._check_live()
        self._impl.merge(self._impl.dispatch(list(texts)))
        self._post_merge()
        return self.snapshot()

    def ingest_tokens(self,
                      token_lists: list[list[str]]) -> ClusterSnapshot:
        """``ingest`` over pre-tokenized documents."""
        self._check_live()
        self._impl.merge(self._impl.dispatch(list(token_lists),
                                             tokenized=True))
        self._post_merge()
        return self.snapshot()

    def ingest_stream(
        self, chunks: Iterable[list], *, tokenized: bool = False,
    ) -> Iterator[ClusterSnapshot]:
        """Multi-chunk ingest with a one-chunk dispatch lookahead.

        Chunk t+1 is dispatched (ids allocated, signatures and bands
        computed) before chunk t is merged.  Yields the cumulative
        snapshot after each chunk, in order; the results equal
        sequential ``ingest`` calls, since merges still run in chunk
        order against the same accumulator and index.
        """
        self._check_live()
        pending = None
        for chunk in chunks:
            nxt = self._impl.dispatch(list(chunk), tokenized=tokenized)
            if pending is not None:
                self._impl.merge(pending)
                self._post_merge()
                yield self.snapshot()
            pending = nxt
        if pending is not None:
            self._impl.merge(pending)
            self._post_merge()
            yield self.snapshot()

    def _merge_precomputed(self, token_lists, sig, bands) -> ClusterSnapshot:
        """Ingest of one chunk whose tokenize, signature and band stages
        the caller already ran (the ``DedupPipeline.run`` adapter).

        One-shot by construction: the cross-step index is skipped (one
        chunk has no earlier chunk to collide with), so the session is
        finalized and takes no further chunks.  ``sig`` and ``bands``
        are numpy uint32 arrays.
        """
        if self._finalized:
            raise ValueError("one-shot session already finalized")
        base = self.allocator.allocate(len(token_lists))
        self._impl.merge((base, token_lists, np.asarray(sig),
                          np.asarray(bands)), index=False)
        self._finalized = True
        return self.snapshot()

    # -- bounded retained state ----------------------------------------------

    def _post_merge(self) -> None:
        """Retention sweep and the refine cadence after a chunk merge."""
        if self.retention is None:
            return
        t0 = time.perf_counter()
        self.retention.sweep(self)
        self.stage_timings["sweep_s"] = time.perf_counter() - t0
        every = self.retention.policy.refine_every
        if every and self.steps_ingested % every == 0:
            self.refine()

    def _release_rows(self, doc_ids) -> None:
        """Evict docs' rows from the session verifier (the sweep's hook).
        An external verifier without ``release_rows`` keeps its rows."""
        v = self._verifier
        if v is not None and hasattr(v, "release_rows"):
            v.release_rows(doc_ids)

    def _compact_band_store(self, doc_ids, root_of) -> None:
        """Rewrite evicted docs' band-store rows onto their cluster roots
        (the sweep's hook; streaming backend only, the host backend's
        retained band state being the ``band_index`` the sweep already
        rewrote).  Keeps the phase-1 store from growing with evicted
        history; see ``bandstore.Design2Store.compact`` and
        ``SqliteBandStore.compact``."""
        compact = getattr(self._impl, "compact_store", None)
        if compact is not None:
            compact(doc_ids, root_of)

    def _representatives(self) -> list[int]:
        """Sorted current union-find roots.

        Gap ids below the session's base (``doc_id_base`` sessions) are
        left out: their verifier rows are blank, so re-banding them would
        collide every gap with every other at a similarity of 1.0.
        """
        if self.retention is not None:
            self.retention.sweep(self)   # roots in step with recent unions
            return self.retention.representatives()
        base = self.allocator.base
        lab = self.uf.components()[: self.n_docs]
        return sorted({int(r) for r in lab[base:]})

    def _rep_band_pairs(self, reps: list[int],
                        est: SignatureVerifier) -> np.ndarray:
        """Re-band the representatives; return their collision pairs.

        Band values are a function of the signature rows, so the reps'
        collisions are the original LSH collisions restricted to the
        root set.  The reps' rows are gathered by row index on the
        verifier's device copy (or uploaded from its host copy, for the
        numpy backend) and folded there: through K5 with
        ``config.use_kernels``, else ``core.lsh.band_values``.  The
        bucket walk is a host dict walk.
        """
        slots = est._slot_index(np.asarray(reps, dtype=np.int64))
        if est._dev is not None:
            dev = est._device_signatures()
            rows = dev[torch.from_numpy(slots).to(dev.device)]
        else:
            rows = u32_from_numpy(est.signatures[slots], est.device)
        fold = (bandfold.band_values if self.config.use_kernels
                else lsh.band_values)
        bands = u32_to_numpy(fold(rows, self.config.rows_per_band))
        # Pairs (old, rep), each bucket's earlier reps before the new one,
        # gathered as two flat columns.
        first: list[int] = []
        second: list[int] = []
        for j in range(bands.shape[1]):
            seen: dict[tuple[int, int], list[int]] = {}
            for rep, key in zip(reps, map(tuple, bands[:, j, :].tolist())):
                olds = seen.get(key)
                if olds is None:
                    seen[key] = [rep]
                else:
                    first.extend(olds)
                    second.extend([rep] * len(olds))
                    olds.append(rep)
        return np.stack([np.array(first, dtype=np.int64),
                         np.array(second, dtype=np.int64)], axis=1)

    def refine(self) -> ClusterSnapshot:
        """Incremental second clustering round (paper §10) over the
        retained representatives.

        Re-bands only the current cluster roots and drives their
        collision pairs through ``engine.merge_cluster_rounds`` with the
        accumulator's verified-sim cache: sims already verified are
        served from it, and this round's become visible to later feeds.
        Merges clusters whose representatives clear ``edge_threshold``.
        Verifiers without signature rows (exact, callback) sweep every
        representative pair instead.  Works with or without a retention
        policy; with one, the rows of deposed roots are then evicted.
        """
        self._check_live()
        t0 = time.perf_counter()
        reps = self._representatives()
        merges, n_pairs, band_s = 0, 0, 0.0
        if len(reps) >= 2 and self._verifier is not None:
            est = self._estimate_verifier()
            cand = None
            if isinstance(est, SignatureVerifier) and est.num_docs:
                t1 = time.perf_counter()
                cand = self._rep_band_pairs(reps, est)
                band_s = time.perf_counter() - t1
                n_pairs = len(cand)
            merges = merge_cluster_rounds(
                self.uf, est, self.config.edge_threshold,
                roots=reps, candidate_pairs=cand,
                sim_cache=self.acc.evaluated)
        self.refine_merges += merges
        self.refines_run += 1
        if self.retention is not None and merges:
            # Second-round unions deposed roots; evict their rows.
            self.retention.sweep(self)
        self.stage_timings.update(refine_s=time.perf_counter() - t0,
                                  refine_band_s=band_s,
                                  refine_pairs=n_pairs,
                                  refine_merges=merges)
        return self.snapshot()

    # -- backend plumbing ----------------------------------------------------

    def _retain(self, token_lists, sig) -> None:
        """Grow the session verifier with one chunk's docs (``sig``:
        numpy uint32 rows, or int32 word rows on the session's device).

        The first chunk builds it, with blank rows for the ids below the
        chunk's base (``doc_id_base`` sessions: those ids have no band
        rows, so they never become candidates); later chunks extend it.
        """
        if self._external_verifier:
            return
        cfg = self.config
        if self._verifier is None:
            gap = self.n_merged  # ids below the first chunk's base
            if self._wants_exact():
                self._verifier = ExactJaccardVerifier.from_token_lists(
                    [[]] * gap + list(token_lists), cfg.ngram)
                return
            full = sig
            if gap:
                blank = np.zeros((gap, sig.shape[1]), dtype=np.uint32)
                full = (torch.cat([u32_from_numpy(blank, sig.device), sig])
                        if isinstance(sig, torch.Tensor)
                        else np.concatenate([blank, sig]))
            cls = (DeviceScoredEdgeVerifier
                   if self.backend == "sharded"
                   and self._impl.stage2 == "device" else SignatureVerifier)
            self._verifier = cls(full, backend=cfg.resolved_backend(),
                                 device=self.device)
        elif self._wants_exact():
            self._verifier.extend_token_lists(token_lists)
        else:
            self._verifier.extend_signatures(sig)

    def _wants_exact(self) -> bool:
        return self.backend == "host" and self.config.exact_verification

    def _estimate_verifier(self) -> BatchVerifier:
        """The verifier for host-made edges (cross-step, the overflow
        retry, ``refine``).

        A ``stage2="device"`` session's own verifier counts registry
        pass-throughs and host re-scores; host-made edges must not count
        as ``n_rescored``, so they go through a shared plain estimator
        over the same rows: the same float32 bits, the same sim cache.
        """
        if not isinstance(self._verifier, DeviceScoredEdgeVerifier):
            return self._verifier
        if self._est_verifier is None:
            self._est_verifier = SignatureVerifier(
                np.zeros((0, self.config.num_hashes), dtype=np.uint32),
                backend=self.config.resolved_backend(), device=self.device)
        # Re-adopt every use: chunk extensions regrow the buffers.
        self._est_verifier.adopt_layout(self._verifier)
        return self._est_verifier

    def _feed_cross_step(self, bands: np.ndarray, base: int) -> int:
        """Cross-step candidates: chunk bands vs the retained index.
        Returns the number of edges fed."""
        edges = self.band_index.match_then_insert(bands, base)
        if len(edges):
            self.acc.feed(ShardedEdgeSource(edges, num_docs=self.n_docs),
                          verifier=self._estimate_verifier())
        return len(edges)


class _NullVerifier(BatchVerifier):
    """Placeholder until the first chunk builds the real verifier (the
    accumulator is built before any signatures exist)."""

    def _verify_batch(self, pairs: np.ndarray) -> np.ndarray:
        raise RuntimeError("session verifier not initialised; "
                           "ingest a chunk first")


class _HostBackend:
    """In-memory per-chunk band matrix (the ``DedupPipeline`` shape)."""

    def __init__(self, sess: DedupSession):
        from repro_torch.core.pipeline import DedupPipeline

        self.sess = sess
        self.pipe = DedupPipeline(sess.config, device=sess.device)
        self.pipe.seeds = sess.seeds

    def dispatch(self, chunk, tokenized: bool = False):
        sess = self.sess
        if sess.config.byte_ingest:
            # Raw UTF-8 bytes go to the device untokenized.  Pre-tokenized
            # chunks are joined with spaces: tokens are alphanumeric, so
            # the byte tokenizer recovers them exactly.
            docs = [" ".join(t) for t in chunk] if tokenized else list(chunk)
            base = sess.allocator.allocate(len(docs))
            if not docs:
                return (base, docs, None, None)
            pad = shingle.pow2_bucket(
                max(len(d.encode("utf-8")) for d in docs) + 1)
            return (base, docs, *self._arrays(
                self.pipe._device_arrays_bytes(docs, pad_len=pad)))
        toks = chunk if tokenized else self.pipe.tokenize(chunk)
        base = sess.allocator.allocate(len(toks))
        if not toks:
            return (base, toks, None, None)
        # The token width buckets to a power of two, as the reference's
        # does to bound its jit compiles; signatures do not depend on it.
        pad = shingle.pow2_bucket(max((len(t) for t in toks), default=1))
        return (base, toks, *self._arrays(
            self.pipe._device_arrays(toks, pad_len=pad)))

    def _arrays(self, device_arrays) -> tuple:
        """A chunk's (signatures, bands) from the pipeline's device
        tensors.  The bands go to the host (the band index and the
        engine read them there); the signatures stay on the device
        unless the verifier is the numpy backend's, so a device verifier
        grows from them without a round trip through the host."""
        sig, bands = device_arrays
        if self.sess.config.resolved_backend() == "numpy":
            sig = u32_to_numpy(sig)
        return sig, u32_to_numpy(bands)

    def merge(self, pending, index: bool = True):
        base, toks, sig, bands = pending
        if sig is None:
            return
        sess = self.sess
        t0 = time.perf_counter()
        sess._retain(toks, sig)
        sess.n_merged = base + len(toks)
        sess.acc.grow(sess.n_docs)
        sess.acc.feed(BandMatrixSource(bands, doc_id_base=base),
                      verifier=sess._verifier)
        t1 = time.perf_counter()
        n_edges = sess._feed_cross_step(bands, base) if index else 0
        t2 = time.perf_counter()
        sess.steps_ingested += 1
        sess.stage_timings.update(merge_s=t2 - t0, cross_step_s=t2 - t1,
                                  cross_step_edges=n_edges)


class _StreamingBackend:
    """Design-2 band store phase 1 and band-major re-scan phase 2.

    Owns (or adopts) a ``streaming.StreamingDedup`` for the store writes.
    Each merge re-scans the whole store through the session accumulator,
    whose verified-sim cache turns the re-scan into candidate
    re-enumeration without re-verification: the paper's "repeat phase 2"
    made incremental.

    An owned memory-tier store hands each flush's signature rows straight
    to the session verifier (on the device unless the verify backend is
    numpy's), so its host cache stays empty; an adopted one keeps its
    cache, which its ``default_verifier`` may rebuild from.  A sqlite
    store writes each flush's rows to disk itself, and the session
    verifies off disk through the store's ``DiskSignatureVerifier``: no
    signature matrix is kept, on the host or the device.
    """

    def __init__(self, sess: DedupSession, *, store_path: str,
                 chunk_docs: int, adopt=None):
        self.sess = sess
        self._owned = adopt is None
        if adopt is not None:
            self.sd = adopt
        else:
            from repro_torch.core.streaming import StreamingDedup

            self.sd = StreamingDedup(sess.config, store_path=store_path,
                                     chunk_docs=chunk_docs,
                                     doc_id_base=sess.allocator.base,
                                     device=sess.device)
            self.sd.seeds = sess.seeds
        self._on_disk = self.sd.store.keeps_signatures
        if self._owned and not self._on_disk:
            self.sd._device_rows = []

    def dispatch(self, chunk, tokenized: bool = False):
        # The store write happens at merge time: a lookahead dispatch must
        # not leak chunk t+1's rows into the scan that merges chunk t.
        if self.sess.config.byte_ingest:
            # Raw texts go to the device as bytes; pre-tokenized chunks are
            # joined with spaces (tokens are alphanumeric, so the byte
            # tokenizer recovers them exactly).
            toks = [" ".join(t) for t in chunk] if tokenized else list(chunk)
        else:
            toks = chunk if tokenized else [shingle.tokenize(t)
                                            for t in chunk]
        return (self.sess.allocator.allocate(len(toks)), toks)

    def merge(self, pending):
        """Phase 1 for the chunk, then the re-scan.  Records ``phase1_s``
        (the store's ``stage_timings`` split it), ``rescan_s`` (the
        scan's ``read_band`` decodes and sorts), ``engine_s`` (the rest
        of the feed: verify and unions) and ``merge_s`` in the session's
        ``stage_timings``."""
        base, toks = pending
        sess = self.sess
        assert base == self.sd.n_docs, (base, self.sd.n_docs)
        t0 = time.perf_counter()
        phase1 = {}
        if toks:
            self.sd.ingest_tokens(toks)
            if self._on_disk:
                # The flushes wrote the rows to the store.
                if sess._verifier is None and not sess._external_verifier:
                    sess._verifier = self.sd.default_verifier()
            elif self._owned:
                sig = torch.cat(self.sd._device_rows)
                self.sd._device_rows.clear()
                if sess.config.resolved_backend() == "numpy":
                    sig = u32_to_numpy(sig)
                sess._retain(toks, sig)
            else:
                sess._retain(toks, np.stack([self.sd._sig_cache[base + i]
                                             for i in range(len(toks))]))
            phase1 = {f"phase1_{k}": v
                      for k, v in self.sd.stage_timings.items()}
        t1 = time.perf_counter()
        sess.n_merged = max(sess.n_merged, base + len(toks))
        sess.acc.grow(sess.n_docs)
        source = self.sd.candidate_source()
        sess.acc.feed(source, verifier=sess._verifier)
        t2 = time.perf_counter()
        sess.steps_ingested += 1
        sess.stage_timings.update(
            phase1_s=t1 - t0, rescan_s=source.scan_s,
            engine_s=t2 - t1 - source.scan_s, merge_s=t2 - t0, **phase1)

    def compact_store(self, doc_ids, root_of):
        """The retention hook: rewrite evicted docs' store rows onto
        their roots (``DedupSession._compact_band_store``)."""
        self.sd.store.compact(doc_ids, root_of)


class _ShardedBackend:
    """One ``dist_lsh.make_streamed_dedup_step`` call a chunk, one
    accumulator across all of them."""

    def __init__(self, sess: DedupSession, *, dist_config, mesh,
                 stream: bool | None):
        from repro_torch.core import dist_lsh

        self.sess = sess
        cfg = sess.config
        self.dcfg = dist_config or dist_lsh.DistLSHConfig(
            ngram=cfg.ngram, num_hashes=cfg.num_hashes,
            rows_per_band=cfg.rows_per_band,
            edge_threshold=cfg.edge_threshold,
            fused_ingest=cfg.fused_ingest,
            byte_ingest=cfg.byte_ingest)
        # The session's retained signatures, seeds and band index come
        # from the DedupConfig, the step's from the DistLSHConfig: they
        # must share one hash space (byte_ingest flips the step's input).
        for f in ("ngram", "num_hashes", "rows_per_band", "byte_ingest"):
            if getattr(cfg, f) != getattr(self.dcfg, f):
                raise ValueError(
                    f"DedupConfig.{f}={getattr(cfg, f)} does not match "
                    f"DistLSHConfig.{f}={getattr(self.dcfg, f)}; the "
                    "session's retained signatures/bands must share the "
                    "sharded step's hash parameters")
        self.mesh = mesh if mesh is not None else dist_lsh.docs_mesh(
            sess.device)
        dev = self.mesh.device
        if dev.type != sess.device.type or (
                sess.device.index is not None
                and dev.index != sess.device.index):
            raise ValueError(f"the mesh runs on {dev}, the session on "
                             f"{sess.device}")
        self.stream = stream
        self.n_dev = self.mesh.n_dev
        self._step = None

    @property
    def stage2(self) -> str:
        return self.dcfg.stage2

    def _get_step(self):
        if self._step is None:
            from repro_torch.core.dist_lsh import make_streamed_dedup_step

            self._step = make_streamed_dedup_step(self.dcfg, self.mesh)
        return self._step

    def _run_step(self, base: int, data, lengths, n_padded: int):
        d_loc = n_padded // self.n_dev
        offsets = DocIdAllocator.device_offsets(base, d_loc, self.n_dev)
        return self._get_step()(data, lengths, self.sess.seeds, offsets)

    def dispatch(self, chunk, tokenized: bool = False):
        """Allocate the chunk's ids and run its step.  The chunk is padded
        to a multiple of the shard count with ``["pad"]`` documents
        (``"pad"`` with byte ingest); their ids lie above the chunk's
        block, and the merge range-filters them."""
        sess = self.sess
        if self.dcfg.byte_ingest:
            docs = [" ".join(t) for t in chunk] if tokenized else list(chunk)
        else:
            docs = chunk if tokenized else [shingle.tokenize(t)
                                            for t in chunk]
        n_real = len(docs)
        base = sess.allocator.allocate(n_real)
        if n_real == 0:
            return (base, docs, 0, None)
        pad = (-n_real) % self.n_dev
        if self.dcfg.byte_ingest:
            # The text "pad" hashes to the token path's ["pad"] row.
            padded = docs + ["pad"] * pad
            packed = shingle.pack_bytes(padded, shingle.pow2_bucket(
                max(len(d.encode("utf-8")) for d in padded) + 1))
            data = packed.data
        else:
            padded = docs + [["pad"]] * pad
            packed = shingle.pack_documents(padded)
            data = packed.tokens
        out = self._run_step(base, data, packed.lengths, len(padded))
        return (base, docs, n_real, out)

    def merge(self, pending):
        """Feed the step's band groups (sweeping between them under a
        retention policy), the retry if a buffer overflowed, then the
        cross-step pass.  Records ``merge_s``, ``feed_s``,
        ``cross_step_s`` and ``cross_step_edges`` in the session's
        ``stage_timings``."""
        from repro_torch.core.dist_lsh import feed_step_groups

        base, toks, n_real, out = pending
        if out is None:
            return
        sess = self.sess
        t0 = time.perf_counter()
        # The gathered rows stay on the device unless the verify backend
        # is numpy's; pad rows never reach the verifier.
        sig = out["sig"][:n_real]
        sess._retain(toks, u32_to_numpy(sig)
                     if sess.config.resolved_backend() == "numpy" else sig)
        sess.n_merged = base + n_real
        sess.acc.grow(sess.n_docs)
        on_group = None
        if sess.retention is not None:
            # Sweep between band-group merges, the chunk's own rows
            # protected: the later groups' edges touch only those rows
            # and current roots.  The cutoff comes from n_merged, set
            # above, never from the allocator (which a lookahead runs
            # one chunk ahead).
            on_group = lambda: sess.retention.sweep(sess, protect_from=base)
        feed = feed_step_groups(
            sess.acc, out, self.dcfg, num_docs=base + n_real,
            edge_offset=0, verifier=sess._verifier, stream=self.stream,
            on_group_merged=on_group)
        sess.overflow += feed.overflow
        sess.row_overflow += feed.row_overflow
        t1 = time.perf_counter()
        bands = u32_to_numpy(lsh.band_values(sig, self.dcfg.rows_per_band))
        if feed.overflow > 0:
            # A buffer dropped this chunk's edges: derive its candidates
            # on the host through the same engine (cross-step edges are
            # host-made and unbounded, so only the chunk's own can be lost).
            sess.retried += 1
            sess.acc.feed(BandMatrixSource(bands, doc_id_base=base),
                          verifier=sess._estimate_verifier())
        t2 = time.perf_counter()
        n_edges = sess._feed_cross_step(bands, base)
        t3 = time.perf_counter()
        sess.steps_ingested += 1
        sess.stage_timings.update(merge_s=t3 - t0, feed_s=t1 - t0,
                                  cross_step_s=t3 - t2,
                                  cross_step_edges=n_edges)
