"""Streaming (out-of-core) dedup: the paper's §12 production mode.

Port of ``repro.core.streaming``.  The paper's 10M-note corpus never
fits memory: it streams notes, writes band signatures to a store, then
reads the store band-major and clusters.  This module has that
two-phase shape:

  Phase 1 (write): stream document chunks -> signatures and band values
    on the device -> a band store (``core.bandstore``): Design 2 under
    ``DedupConfig(store="memory")``, or the sqlite tier, which keeps
    the signature rows on disk too.
  Phase 2 (read): band-major scan over the store through the staged
    engine (``candidates.StoreBandSource`` -> batched verify ->
    ``ThresholdUnionFind``).

Phase 1 can be appended to as new notes arrive, and phase 2 re-run at
other edge thresholds without recomputing signatures.

Each flush of ``chunk_docs`` documents runs the ``DedupPipeline`` device
path on ``device`` (``"cuda"`` unless told): K1 with ``fused_ingest``,
``bytes_to_bands`` (K6, compaction, K1) with ``byte_ingest``, K3 and K4
with ``use_kernels``, else the plain PyTorch chain.  The band values
come to the host, where the store lives.  ``merge_cluster_rounds`` is
the paper's §10 second clustering round.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core import minhash, shingle
from repro_torch.core.bandstore import (
    DiskSignatureVerifier,
    make_store,
)
from repro_torch.core.candidates import StoreBandSource
from repro_torch.core.engine import merge_cluster_rounds as _merge_rounds
from repro_torch.core.hashing import u32_to_numpy
from repro_torch.core.pipeline import DedupConfig, DedupPipeline
from repro_torch.core.unionfind import ThresholdUnionFind
from repro_torch.core.verify import (
    BatchVerifier,
    SignatureVerifier,
    as_verifier,
)
from repro_torch.device import resolve_device


@dataclass
class StreamingDedup:
    """Two-phase streaming dedup over a band store (``config.store``).

    ``doc_id_base`` assigns global doc ids from that base: resumed
    ingest of a chunked corpus writes non-contiguous id ranges into the
    store, which keeps each row's doc id explicitly.  ``device`` is
    where phase 1's signatures and bands and the default verifier run.

    A sqlite store takes each flush's signature rows itself
    (``put_signatures``).  Over a memory-tier store they are cached on
    the host (``_sig_cache``, doc id -> row) for ``default_verifier``,
    unless an owning session has set ``_device_rows`` to a list: then
    they are appended there as the pipeline's word tensors, and the
    cache stays empty (the session's verifier takes them on the device).
    ``stage_timings`` holds the last ``ingest_tokens`` call's phase-1
    wall times, summed over its flushes: ``pack_s``, ``upload_s``,
    ``kernel_s`` (the pipeline's device stages), ``download_s`` (band
    values and cached rows to the host) and ``store_s`` (store writes
    and commit), and its ``flushes``.
    """

    config: DedupConfig = field(default_factory=DedupConfig)
    store_path: str = ":memory:"
    chunk_docs: int = 512
    doc_id_base: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.store = make_store(self.config.store, self.store_path,
                                part_size=self.chunk_docs,
                                num_bands=self.config.num_bands)
        self.pipe = DedupPipeline(self.config, device=self.device)
        self.seeds = minhash.default_seeds(self.config.num_hashes)
        self.n_docs = int(self.doc_id_base)
        self.n_ingested = 0
        self._sig_cache: dict[int, np.ndarray] = {}
        self._device_rows: list | None = None
        self.stage_timings: dict[str, float] = {}

    # -- phase 1 -----------------------------------------------------------

    def ingest(self, texts: Iterable[str], keep_signatures: bool = True):
        """Stream documents into the band store, chunk by chunk."""
        if self.config.byte_ingest:
            # Raw texts are buffered and go to the device as UTF-8 bytes:
            # no host tokenize pass.
            self.ingest_tokens(texts, keep_signatures)
            return
        self.ingest_tokens(
            (shingle.tokenize(t) for t in texts), keep_signatures)

    def ingest_tokens(self, token_lists: Iterable[list[str]],
                      keep_signatures: bool = True):
        """Ingest pre-tokenized documents (raw texts under byte ingest),
        flushing every ``chunk_docs``."""
        self.stage_timings = dict.fromkeys(
            ("pack_s", "upload_s", "kernel_s", "download_s", "store_s"), 0.0)
        self.stage_timings["flushes"] = 0
        buf: list = []
        for toks in token_lists:
            buf.append(toks)
            if len(buf) == self.chunk_docs:
                self._flush(buf, keep_signatures)
                buf = []
        if buf:
            self._flush(buf, keep_signatures)
        t0 = time.perf_counter()
        self.store.commit()
        self.stage_timings["store_s"] += time.perf_counter() - t0

    def _flush(self, token_lists, keep_signatures):
        # The padded width buckets to a power of two, as the reference's
        # does to bound its jit compiles; signatures do not depend on it.
        self.pipe.seeds = self.seeds
        if self.config.byte_ingest:
            pad_len = shingle.pow2_bucket(
                max((len(t if isinstance(t, bytes) else t.encode("utf-8"))
                     for t in token_lists), default=0) + 1)
            sig, bands = self.pipe._device_arrays_bytes(token_lists, pad_len)
        else:
            pad_len = shingle.pow2_bucket(
                max((len(t) for t in token_lists), default=1))
            sig, bands = self.pipe._device_arrays(token_lists, pad_len)
        t = self.stage_timings
        pt = self.pipe.stage_timings
        t["pack_s"] += pt["pack_s"]
        t["upload_s"] += pt["upload_s"]
        t["kernel_s"] += pt["ingest_s"]
        t["flushes"] += 1
        self._store_chunk(sig, bands, len(token_lists), keep_signatures)

    def _store_chunk(self, sig, bands, n, keep_signatures):
        """Write one flushed chunk's band rows to the store, and keep its
        signature rows: written to a sqlite store, else kept in
        ``_device_rows`` or the host cache."""
        t0 = time.perf_counter()
        bands = u32_to_numpy(bands)
        ids = range(self.n_docs, self.n_docs + n)
        on_disk = None
        if keep_signatures and self.store.keeps_signatures:
            on_disk = u32_to_numpy(sig[:n])
        elif keep_signatures and self._device_rows is not None:
            self._device_rows.append(sig)
        elif keep_signatures:
            self._sig_cache.update(zip(ids, u32_to_numpy(sig)))
        t1 = time.perf_counter()
        self.store.put_band_rows(ids, bands)
        if on_disk is not None:
            self.store.put_signatures(ids, on_disk)
        t2 = time.perf_counter()
        self.stage_timings["download_s"] += t1 - t0
        self.stage_timings["store_s"] += t2 - t1
        self.n_docs += n
        self.n_ingested += n

    # -- phase 2 -----------------------------------------------------------

    def candidate_source(self) -> StoreBandSource:
        """The staged-engine candidate source over the band store."""
        return StoreBandSource(self.store, self.config.num_bands,
                               self.n_docs)

    def default_verifier(self) -> BatchVerifier:
        """Signature-agreement verifier over the phase-1 rows.

        A sqlite store holds the rows on disk: the verifier is a
        ``DiskSignatureVerifier`` over it on ``device`` (K2', the same
        sims).  Over a memory-tier store it builds the full (n_docs, M)
        matrix from the host cache, indexed by global doc id: rows below
        ``doc_id_base`` or inside a resumed-ingest gap stay zero.  Those
        ids have no store rows, so they never reach the verifier as
        candidates.
        """
        if self.store.keeps_signatures:
            held = self.store.n_signatures()
            if held < self.n_ingested:
                raise ValueError(
                    f"store holds {held} of {self.n_ingested} ingested "
                    "docs' signature rows; ingest with "
                    "keep_signatures=True or pass an explicit "
                    "similarity_fn / verifier to cluster()")
            return DiskSignatureVerifier(self.store, self.config.num_hashes,
                                         device=self.device)
        if len(self._sig_cache) < self.n_ingested:
            raise ValueError(
                f"signature cache holds {len(self._sig_cache)} of "
                f"{self.n_ingested} ingested docs; ingest with "
                "keep_signatures=True or pass an explicit "
                "similarity_fn / verifier to cluster()")
        sig = np.zeros((self.n_docs, self.config.num_hashes),
                       dtype=np.uint32)
        for i, row in self._sig_cache.items():
            sig[i] = row
        return SignatureVerifier(sig, backend=self.config.resolved_backend(),
                                 device=self.device)

    def cluster(self, edge_threshold: float | None = None,
                tree_threshold: float | None = None,
                similarity_fn: Callable[[int, int], float]
                | BatchVerifier | None = None):
        """Band-major read -> candidates -> batched verify -> union-find.

        The one-shot snapshot of ``DedupSession.over_store``: the phase-2
        scan runs through a session accumulator.  ``similarity_fn`` is a
        ``BatchVerifier`` or a scalar callable; it defaults to signature
        agreement over the phase-1 cache.  Re-runnable at other
        thresholds without re-hashing (paper §12).  Returns the
        union-find and the scan's verify counters.
        """
        from repro_torch.core.session import DedupSession

        cfg = self.config
        edge_t = (edge_threshold if edge_threshold is not None
                  else cfg.edge_threshold)
        tree_t = (tree_threshold if tree_threshold is not None
                  else cfg.tree_threshold)
        verifier = (None if similarity_fn is None
                    else as_verifier(similarity_fn))
        sess = DedupSession.over_store(
            self, config=replace(cfg, edge_threshold=edge_t,
                                 tree_threshold=tree_t),
            verifier=verifier)
        snap = sess.snapshot()
        return sess.uf, {"pairs_evaluated": snap.stats.pairs_evaluated,
                         "pairs_excluded": snap.stats.pairs_excluded,
                         "verify_batches": snap.stats.verify_batches,
                         "verify_seconds": snap.stats.verify_seconds}


def merge_cluster_rounds(
    uf: ThresholdUnionFind,
    similarity_fn: Callable[[int, int], float] | BatchVerifier,
    edge_threshold: float,
) -> int:
    """Paper §10's second clustering round (``engine.merge_cluster_rounds``):
    root-pair similarities in batched dispatches.  Returns the number of
    merges."""
    return _merge_rounds(uf, similarity_fn, edge_threshold)
