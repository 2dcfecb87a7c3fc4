"""Candidate generation of the staged dedup engine (paper §3.6/§4).

Port of ``repro.core.candidates`` (host numpy code)::

    CandidateSource  ->  BatchVerifier  ->  ThresholdUnionFind
    (band runs)          (batched sims)     (guarded unions)

Per band, the ``(band_value, doc)`` pairs are sorted lexicographically
and the equal-value runs are the candidate groups (the paper's
sort-based method, §3.6 method 2).  ``BandMatrixSource`` reads a dense
in-memory ``(D, b, 2)`` band matrix, the ``DedupPipeline`` path.
``StoreBandSource`` reads a band store band by band
(``core.bandstore``), the streaming mode's phase 2.
``ShardedEdgeSource`` reads the prescreened edge buffers of the sharded
step (``dist_lsh``): each surviving edge is a two-member run, so the
sharded path's host merge drives the same engine; ``EdgeStreamSource``
reads those buffers one band group at a time.  Doc ids are int64
throughout, so global ids of chunked corpora past 2**31 cannot wrap.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.hashing import u32_to_numpy


@dataclass(frozen=True)
class BandRuns:
    """One band's sorted values/docs plus its equal-value run boundaries.

    ``sorted_vals``: (N, 2) uint32 band values, lexicographically sorted;
    ``sorted_docs``: (N,) int64 doc ids in the same order;
    ``run_starts``/``run_ends``: index ranges of equal-value runs
    (every position belongs to exactly one run; singleton runs included).
    """

    band_id: int
    sorted_vals: np.ndarray
    sorted_docs: np.ndarray
    run_starts: np.ndarray
    run_ends: np.ndarray

    def iter_groups(self) -> Iterator[np.ndarray]:
        """Yield the doc-id array of every run with >= 2 members."""
        for s, e in zip(self.run_starts, self.run_ends):
            if e - s >= 2:
                yield self.sorted_docs[s:e]


def lexsort_band(vals: np.ndarray, docs: np.ndarray):
    """Sort one band's (value, doc) pairs by (hi, lo) value lanes."""
    order = np.lexsort((vals[:, 1], vals[:, 0]))
    return vals[order], docs[order]


def run_boundaries(sorted_vals: np.ndarray):
    """Equal-value run (starts, ends) of a sorted (N, 2) value array."""
    n = len(sorted_vals)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    heads = np.ones(n, dtype=bool)
    heads[1:] = np.any(sorted_vals[1:] != sorted_vals[:-1], axis=-1)
    starts = np.flatnonzero(heads)
    ends = np.append(starts[1:], n)
    return starts, ends


def make_band_runs(band_id: int, vals: np.ndarray,
                   docs: np.ndarray) -> BandRuns:
    """Sort one band and find its runs (the shared sort->runs step)."""
    sv, sd = lexsort_band(np.asarray(vals), np.asarray(docs, dtype=np.int64))
    starts, ends = run_boundaries(sv)
    return BandRuns(band_id=band_id, sorted_vals=sv, sorted_docs=sd,
                    run_starts=starts, run_ends=ends)


@runtime_checkable
class CandidateSource(Protocol):
    """Anything that can yield per-band sorted run structures."""

    @property
    def num_docs(self) -> int: ...

    @property
    def num_bands(self) -> int: ...

    def iter_bands(self) -> Iterator[BandRuns]: ...


class BandMatrixSource:
    """In-memory (D, b, 2) band matrix (the host-pipeline source).

    ``doc_id_base`` maps row i to global doc id ``doc_id_base + i``, for
    a chunk whose band matrix is row-local but clusters into a global
    union-find.
    """

    def __init__(self, bands: np.ndarray, doc_id_base: int = 0):
        bands = np.asarray(bands)
        if bands.ndim != 3 or bands.shape[-1] != 2:
            raise ValueError(f"expected a (D, b, 2) band matrix, got "
                             f"shape {bands.shape}")
        self.bands = bands
        self.doc_id_base = int(doc_id_base)
        self._doc_ids = self.doc_id_base + np.arange(
            bands.shape[0], dtype=np.int64)

    @property
    def num_docs(self) -> int:
        return self.doc_id_base + self.bands.shape[0]

    @property
    def num_bands(self) -> int:
        return self.bands.shape[1]

    def iter_bands(self) -> Iterator[BandRuns]:
        for j in range(self.num_bands):
            yield make_band_runs(j, self.bands[:, j, :], self._doc_ids)


class StoreBandSource:
    """Out-of-core source over a band store (Design 1 or Design 2).

    ``store`` needs only ``read_band(j) -> (doc_ids, values)``, the
    paper's "select * where band_id = j" access pattern (§5.2).  The
    streaming two-phase mode reads its phase 2 through this source.
    ``scan_s`` sums the wall time of the reads and sorts so far.
    """

    def __init__(self, store, num_bands: int, num_docs: int):
        self.store = store
        self._num_bands = int(num_bands)
        self._num_docs = int(num_docs)
        self.scan_s = 0.0

    @property
    def num_docs(self) -> int:
        return self._num_docs

    @property
    def num_bands(self) -> int:
        return self._num_bands

    def iter_bands(self) -> Iterator[BandRuns]:
        for j in range(self._num_bands):
            t0 = time.perf_counter()
            docs, vals = self.store.read_band(j)
            runs = make_band_runs(j, vals, docs)
            self.scan_s += time.perf_counter() - t0
            yield runs


class ShardedEdgeSource:
    """Source over the per-device prescreened edge buffers of ``dist_lsh``.

    The sharded step emits bounded ``(head_doc, member_doc)`` edge
    buffers, one per device (``(n_dev * e_cap, 2)`` after the gather in
    rank order), with a validity mask.  Each surviving edge becomes a
    two-member run, and ``iter_bands`` yields one ``BandRuns`` per
    device buffer (``num_shards`` equal splits, as ``np.array_split``
    cuts them).  Edges with an id outside ``[0, num_docs)`` -- padding
    documents, empty slots, other chunks' documents -- are dropped, so
    they can never union with real documents.
    """

    def __init__(self, edges: np.ndarray, edge_mask: np.ndarray | None = None,
                 *, num_docs: int, num_shards: int = 1):
        edges = np.asarray(edges).reshape(-1, 2)
        if edge_mask is None:
            mask = np.ones(len(edges), dtype=bool)
        else:
            mask = np.asarray(edge_mask).reshape(-1).astype(bool)
        if len(mask) != len(edges):
            raise ValueError(f"edge mask of {len(mask)} slots for "
                             f"{len(edges)} edges")
        self._num_docs = int(num_docs)
        self._shards: list[np.ndarray] = []
        for e, m in zip(np.array_split(edges, num_shards),
                        np.array_split(mask, num_shards)):
            e = e[m].astype(np.int64)
            e = e[(e >= 0).all(axis=-1) & (e < self._num_docs).all(axis=-1)]
            self._shards.append(e)

    @classmethod
    def from_device_buffers(cls, edges, edge_mask=None, *, num_docs: int,
                            num_shards: int = 1,
                            edge_offset: int = 0) -> "ShardedEdgeSource":
        """Bring the step's edge buffers to the host as a source.

        ``edges`` is a word tensor (int32 bits of uint32 ids) or a numpy
        uint32 array; ``edge_mask`` a bool tensor or array.
        ``edge_offset`` is subtracted from every id (in int64, so no id
        wraps): the ``doc_id_base`` shift of a chunk of a larger corpus
        back to its local rows.
        """
        edges = host_u32(edges).astype(np.int64) - int(edge_offset)
        if edge_mask is not None:
            edge_mask = host_array(edge_mask)
        return cls(edges, edge_mask, num_docs=num_docs,
                   num_shards=num_shards)

    @property
    def num_docs(self) -> int:
        return self._num_docs

    @property
    def num_bands(self) -> int:
        return len(self._shards)

    @property
    def num_edges(self) -> int:
        return sum(len(e) for e in self._shards)

    def iter_bands(self) -> Iterator[BandRuns]:
        for i, e in enumerate(self._shards):
            n = len(e)
            # A made-up band value per edge: run j is edge j's doc pair.
            vals = np.zeros((2 * n, 2), dtype=np.uint32)
            vals[:, 0] = np.repeat(np.arange(n, dtype=np.uint32), 2)
            starts = 2 * np.arange(n, dtype=np.int64)
            yield BandRuns(band_id=i, sorted_vals=vals,
                           sorted_docs=e.reshape(-1),
                           run_starts=starts, run_ends=starts + 2)


class EdgeStreamSource:
    """``ShardedEdgeSource`` over per-group buffers, one group at a time.

    The band-group streamed ``dist_lsh`` step emits one ``(edges,
    mask)`` buffer per band group.  This source brings group g's buffer
    to the host only when the engine reaches it, so the host merge of
    group g can overlap the device work still queued for later groups.

    ``groups`` is an iterable of ``(edges, mask)`` (tensors or arrays;
    mask may be None).  ``edge_offset`` is subtracted from edge ids
    before the range filter (the ``doc_id_base`` shift of chunked
    corpora).  ``on_group(g, edges, mask)`` runs right after group g is
    brought over and before its edges are fed.
    """

    def __init__(self, groups, *, num_docs: int, num_shards: int = 1,
                 edge_offset: int = 0, on_group=None):
        self._groups = groups
        self._num_docs = int(num_docs)
        self._num_shards = int(num_shards)
        self._edge_offset = int(edge_offset)
        self._on_group = on_group
        self.num_edges = 0
        self.groups_consumed = 0

    @property
    def num_docs(self) -> int:
        return self._num_docs

    @property
    def num_bands(self) -> int:
        """BandRuns yielded so far (groups consumed x device shards)."""
        return self.groups_consumed * self._num_shards

    def iter_bands(self) -> Iterator[BandRuns]:
        for g, (edges, mask) in enumerate(self._groups):
            src = ShardedEdgeSource.from_device_buffers(
                edges, mask, num_docs=self._num_docs,
                num_shards=self._num_shards, edge_offset=self._edge_offset)
            if self._on_group is not None:
                self._on_group(g, edges, mask)
            self.num_edges += src.num_edges
            self.groups_consumed += 1
            yield from src.iter_bands()


def host_u32(x) -> np.ndarray:
    """A word tensor or a uint32 array as a numpy uint32 array."""
    if isinstance(x, torch.Tensor):
        return u32_to_numpy(x)
    return np.asarray(x, dtype=np.uint32)


def host_array(x) -> np.ndarray:
    """A tensor (any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pairs_in_runs(
    sorted_vals: np.ndarray,
    sorted_docs: np.ndarray,
    max_pairs: int | None = None,
) -> np.ndarray:
    """All pairs within equal runs of one sorted band (O(run^2)).

    Returns (P, 2) int64 candidate pairs with a < b by doc id, at most
    ``max_pairs`` of them when given.
    """
    starts, ends = run_boundaries(np.asarray(sorted_vals))
    pairs = []
    total = 0
    for s, e in zip(starts, ends):
        k = e - s
        if k < 2:
            continue
        docs = np.sort(np.asarray(sorted_docs[s:e], dtype=np.int64))
        ii, jj = np.triu_indices(k, k=1)
        p = np.stack([docs[ii], docs[jj]], axis=-1)
        pairs.append(p)
        total += len(p)
        if max_pairs is not None and total >= max_pairs:
            break
    if not pairs:
        return np.zeros((0, 2), dtype=np.int64)
    out = np.concatenate(pairs)
    return out[:max_pairs] if max_pairs is not None else out


def candidate_pairs(
    source: CandidateSource, max_pairs_per_band: int | None = None
) -> np.ndarray:
    """All candidate pairs of a source, deduplicated across bands.

    Returns a sorted (P, 2) int64 array.
    """
    seen: set[tuple[int, int]] = set()
    for br in source.iter_bands():
        pairs = pairs_in_runs(br.sorted_vals, br.sorted_docs,
                              max_pairs_per_band)
        seen.update(map(tuple, pairs.tolist()))
    if not seen:
        return np.zeros((0, 2), dtype=np.int64)
    return np.array(sorted(seen), dtype=np.int64)
