"""Batched pair verification of the staged dedup engine.

Port of ``repro.core.verify``.  A ``BatchVerifier`` maps a (P, 2) int
array of candidate doc pairs to a (P,) float32 similarity vector in
batches:

===================  =====================================================
verifier             computes
===================  =====================================================
SignatureVerifier    signature-agreement estimate m/M (paper §3.4) over
                     gathered signature rows; backend ``numpy`` (host),
                     ``torch`` (``minhash.estimate_jaccard`` on the
                     device) or ``kernel`` (K2, ``kernels.sigjaccard``)
ExactJaccardVerifier exact set Jaccard (paper §2.1) vectorized over
                     sorted interned n-gram id arrays
ShardedEdgeVerifier  full-signature re-verify of the ``dist_lsh`` prefix
                     prescreen survivors (stage 2 of the sharded path);
                     SignatureVerifier's estimator and backends
DeviceScoredEdge-    stage 2 for ``stage2="device"``: serves the scores
Verifier             K7 computed on the device, re-scores only the rest
CallbackVerifier     wrapper around a scalar ``fn(a, b) -> float``
===================  =====================================================

All three estimate backends return the same float32 bits as numpy's
``(a == b).mean(axis=-1, dtype=np.float32)``.  All verifiers record
``n_batches`` / ``n_pairs`` / ``seconds``.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import minhash
from repro_torch.core.hashing import u32_from_numpy, u32_to_numpy
from repro_torch.core.shingle import ngram_set
from repro_torch.device import resolve_device
from repro_torch.kernels import sigjaccard

BACKENDS = ("numpy", "torch", "kernel")


class BatchVerifier:
    """Base class: ``verifier(pairs (P, 2)) -> sims (P,) float32``.

    Subclasses implement ``_verify_batch``; ``__call__`` handles
    batching, empty input, and throughput accounting.
    """

    batch_pairs: int = 8192

    def __init__(self):
        self.n_batches = 0
        self.n_pairs = 0
        self.seconds = 0.0

    def _verify_batch(self, pairs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, pairs: np.ndarray) -> np.ndarray:
        pairs = np.asarray(pairs)
        if pairs.size == 0:
            return np.zeros((0,), dtype=np.float32)
        pairs = pairs.reshape(-1, 2)
        t0 = time.perf_counter()
        out = np.empty(len(pairs), dtype=np.float32)
        for s in range(0, len(pairs), self.batch_pairs):
            chunk = pairs[s : s + self.batch_pairs]
            out[s : s + len(chunk)] = np.asarray(
                self._verify_batch(chunk), dtype=np.float32)
            self.n_batches += 1
        self.n_pairs += len(pairs)
        self.seconds += time.perf_counter() - t0
        return out

    @property
    def pairs_per_second(self) -> float:
        return self.n_pairs / self.seconds if self.seconds > 0 else 0.0


class CallbackVerifier(BatchVerifier):
    """Wrap a scalar ``similarity_fn(a, b) -> float``."""

    def __init__(self, fn: Callable[[int, int], float]):
        super().__init__()
        self.fn = fn

    def _verify_batch(self, pairs: np.ndarray) -> np.ndarray:
        return np.array(
            [self.fn(int(a), int(b)) for a, b in pairs], dtype=np.float32)


class _SlotPool:
    """The eviction layout of a verifier's row matrix.

    ``slot_of`` maps each retained doc to its physical row (the surface a
    ``SessionView`` copies); ``slot_arr`` holds the same map as an array
    indexed by doc id, -1 for an evicted doc, so a batch of pairs maps to
    rows in one gather; ``free`` lists the released rows, reused last
    released first.
    """

    def __init__(self, n_rows: int):
        self.slot_of: dict[int, int] = {i: i for i in range(n_rows)}
        self.slot_arr = np.arange(n_rows, dtype=np.int64)
        self.free: list[int] = []

    def index(self, ids: np.ndarray, kind: str) -> np.ndarray:
        """Doc ids -> rows; ``KeyError`` naming the first evicted doc."""
        ids = np.asarray(ids, dtype=np.int64)
        n = len(self.slot_arr)
        slots = self.slot_arr[np.clip(ids, 0, max(n - 1, 0))] if n else \
            np.full(ids.shape, -1, dtype=np.int64)
        bad = (ids < 0) | (ids >= n) | (slots < 0)
        if bad.any():
            doc = int(ids.ravel()[np.flatnonzero(bad.ravel())[0]])
            raise KeyError(
                f"doc {doc} has no retained {kind} row (evicted by the "
                "retention policy); only union-find roots and the LRU "
                "window are verifiable")
        return slots

    def release(self, doc_ids) -> list[int]:
        """Free the rows of ``doc_ids``; returns them.  An unknown or
        already released doc raises (after the docs before it)."""
        slots = []
        for d in doc_ids:
            d = int(d)
            try:
                slot = self.slot_of.pop(d)
            except KeyError:
                raise KeyError(f"doc {d} has no retained row to release")
            self.slot_arr[d] = -1
            self.free.append(slot)
            slots.append(slot)
        return slots

    def place(self, doc0: int, count: int, n_rows: int) -> np.ndarray:
        """Rows for the ``count`` new docs ``doc0, doc0 + 1, ...``: freed
        rows first (last released first), then rows ``n_rows`` onward."""
        k = min(count, len(self.free))
        reused = self.free[len(self.free) - k:][::-1]
        del self.free[len(self.free) - k:]
        slots = np.concatenate([
            np.asarray(reused, dtype=np.int64),
            np.arange(n_rows, n_rows + count - k, dtype=np.int64)])
        need = doc0 + count
        if need > len(self.slot_arr):
            arr = np.full(max(need, 2 * len(self.slot_arr)), -1,
                          dtype=np.int64)
            arr[: len(self.slot_arr)] = self.slot_arr
            self.slot_arr = arr
        self.slot_arr[doc0:need] = slots
        self.slot_of.update(zip(range(doc0, need), slots.tolist()))
        return slots


class SignatureVerifier(BatchVerifier):
    """Signature-agreement estimate over gathered signature rows.

    ``signatures`` is a (D, M) numpy uint32 array or an int32 word tensor
    (``core.hashing``).  ``backend``:

    * ``"numpy"``  -- host ``(sig[a] == sig[b]).mean(-1, dtype=float32)``;
    * ``"torch"``  -- gather and ``minhash.estimate_jaccard`` on ``device``;
    * ``"kernel"`` -- K2 (``kernels.sigjaccard.pair_counts``) on
      ``device``, counts divided by M in PyTorch.

    ``device`` defaults to ``"cuda"`` and raises without a CUDA device
    unless ``"cpu"`` is passed; on the CPU the kernel backend runs K2's
    plain version.

    Row i holds doc i until the first ``release_rows`` call (retention),
    which switches to the eviction layout: an explicit doc -> row map
    with a pool of freed rows that later ``extend_signatures`` calls fill
    first.  ``num_docs`` counts the doc ids ever given rows, ``_n_rows``
    the physical rows in use.
    """

    def __init__(self, signatures, backend: str = "numpy",
                 batch_pairs: int = 8192, *, device="cuda"):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.backend = backend
        self.batch_pairs = int(batch_pairs)
        self.device = resolve_device(device)
        # Up to two copies of the matrix, each a capacity-doubling buffer
        # whose first ``_n_rows`` rows are in use: the host copy (numpy
        # uint32) and the device copy (int32 words on ``device``).
        # Either is made from the other at first use; after that every
        # ``extend_signatures`` writes to each copy that exists, so the
        # device copy grows on the device and is never uploaded again.
        self._host: np.ndarray | None = None
        self._dev: torch.Tensor | None = None
        if isinstance(signatures, torch.Tensor):
            self._dev = signatures.to(self.device)
        else:
            self._host = np.asarray(signatures, dtype=np.uint32)
        self._n_rows = len(signatures)
        self._n_docs = len(signatures)
        self._slots: _SlotPool | None = None  # the eviction layout

    @property
    def num_docs(self) -> int:
        """Doc ids given rows so far (evicted ones included)."""
        return self._n_docs

    @property
    def n_live_rows(self) -> int:
        """Rows holding a retained document's signature."""
        if self._slots is None:
            return self._n_rows
        return len(self._slots.slot_of)

    @property
    def signatures(self) -> np.ndarray:
        """The (R, M) uint32 row matrix on the host: row i == doc i until
        the first eviction, then the rows of ``_slot_index``."""
        if self._host is None:
            self._host = u32_to_numpy(self._device_signatures())
        return self._host[: self._n_rows]

    def _device_signatures(self) -> torch.Tensor:
        """The (R, M) matrix as int32 words on ``device``: a contiguous
        row prefix of the growth buffer, so its rows keep the buffer's
        alignment."""
        if self._dev is None:
            self._dev = u32_from_numpy(self.signatures, self.device)
        return self._dev[: self._n_rows]

    def _slot_index(self, ids) -> np.ndarray:
        """Global doc ids -> physical rows (one array gather)."""
        ids = np.asarray(ids, dtype=np.int64)
        if self._slots is None:
            return ids
        return self._slots.index(ids, "signature")

    def release_rows(self, doc_ids) -> int:
        """Evict docs' signature rows into the free-row pool.

        The first call switches to the eviction layout.  Freed rows are
        reused by later ``extend_signatures`` calls, so the matrix stops
        growing once eviction keeps pace with ingest.  Releasing an
        unknown or already released doc raises ``KeyError``.
        """
        if self._slots is None:
            # Views frozen so far share the host row prefix, and freed
            # rows are rewritten in place from now on: one copy, once.
            if self._host is not None:
                self._host = self._host.copy()
            self._slots = _SlotPool(self._n_rows)
        return len(self._slots.release(doc_ids))

    def adopt_layout(self, other: "SignatureVerifier") -> None:
        """Share ``other``'s row buffers and layout (no copy).  A view
        kept over another verifier's matrix re-adopts before each use,
        since the owner's growth replaces its buffers."""
        self._host, self._dev = other._host, other._dev
        self._n_rows, self._n_docs = other._n_rows, other._n_docs
        self._slots = other._slots

    def rows_for(self, doc_ids) -> np.ndarray:
        """Retained signature rows for ``doc_ids``, on the host."""
        ids = np.asarray(doc_ids, dtype=np.int64)
        if ids.size == 0:
            return np.zeros((0, self._width), dtype=np.uint32)
        return self.signatures[self._slot_index(ids)]

    def frozen_rows(self) -> tuple[np.ndarray, dict | None]:
        """(signatures, doc -> row): the read path's snapshot of the rows.

        Row i == doc i (``None`` for the map): extensions only write past
        this row bound or into a new buffer, so the current host row
        prefix never changes and is shared as is.  In the eviction layout
        freed rows are rewritten in place by later chunks, so the live
        rows are copied together with the map.
        """
        if self._slots is None:
            return self.signatures, None
        return self.signatures.copy(), dict(self._slots.slot_of)

    def extend_signatures(self, rows) -> None:
        """Add the signature rows of newly ingested docs, in doc order.

        ``rows`` is a (C, M) numpy uint32 array or int32 word tensor.
        Row i == doc i: each existing copy grows by capacity doubling, so
        a chunk costs O(chunk) amortized.  In the eviction layout freed
        rows are filled first, in every copy that exists, by one indexed
        copy a chunk.  The throughput counters carry over.
        """
        C = len(rows)
        if C == 0:
            return
        M = self._width
        if rows.shape[-1] != M:
            raise ValueError(f"signature width {rows.shape[-1]} != existing {M}")
        n0 = self._n_rows
        if self._slots is None:
            slots = None
            n1 = n0 + C
        else:
            slots = self._slots.place(self._n_docs, C, n0)
            n1 = max(n0, int(slots.max()) + 1)
        if self._host is not None:
            host = (u32_to_numpy(rows) if isinstance(rows, torch.Tensor)
                    else np.asarray(rows, dtype=np.uint32))
            if n1 > len(self._host):
                buf = np.empty((max(n1, 2 * n0), M), dtype=np.uint32)
                buf[:n0] = self._host[:n0]
                self._host = buf
            if slots is None:
                self._host[n0:n1] = host
            else:
                self._host[slots] = host
        if self._dev is not None:
            dev = (rows.to(self.device) if isinstance(rows, torch.Tensor)
                   else u32_from_numpy(rows, self.device))
            if n1 > len(self._dev):
                buf = torch.empty((max(n1, 2 * n0), M), dtype=torch.int32,
                                  device=self.device)
                buf[:n0] = self._dev[:n0]
                self._dev = buf
            if slots is None:
                self._dev[n0:n1] = dev
            else:
                self._dev.index_copy_(
                    0, torch.from_numpy(slots).to(self.device), dev)
        self._n_rows = n1
        self._n_docs += C

    @property
    def _width(self) -> int:
        """M, the signature width."""
        buf = self._host if self._host is not None else self._dev
        return buf.shape[1]

    def _upload_pairs(self, pairs: np.ndarray):
        """The two index columns of a (P, 2) int64 batch on ``device``,
        as rows of one (2, P) block moved in one copy."""
        block = torch.from_numpy(np.ascontiguousarray(pairs.T)).to(self.device)
        return block[0], block[1]

    def _verify_batch(self, pairs: np.ndarray) -> np.ndarray:
        rows = self._slot_index(pairs)
        if rows.min() < 0 or rows.max() >= self._n_rows:
            raise IndexError(f"pair row outside [0, {self._n_rows})")
        if self.backend == "numpy":
            sig = self.signatures
            a_idx, b_idx = rows[:, 0], rows[:, 1]
            return (sig[a_idx] == sig[b_idx]).mean(axis=-1, dtype=np.float32)
        sig = self._device_signatures()
        a, b = self._upload_pairs(rows)
        if self.backend == "torch":
            est = minhash.estimate_jaccard(sig[a], sig[b])
        else:
            est = minhash.estimate_from_counts(
                sigjaccard.pair_counts(sig, a, b), sig.shape[1])
        return est.cpu().numpy()


class ShardedEdgeVerifier(SignatureVerifier):
    """Stage 2 of the sharded path's two-stage verify (``dist_lsh``).

    Stage 1, inside the step, keeps the edges whose ``verify_k``-word
    signature prefix estimate clears ``edge_threshold -
    prescreen_margin``; this verifier re-scores the survivors against
    the full (D, M) signature matrix with ``SignatureVerifier``'s
    estimator and backends, so thresholds and estimates cannot drift
    between the sharded and host engines.
    """

    @classmethod
    def from_step_output(cls, out, backend: str = "numpy",
                         batch_pairs: int = 8192, *,
                         device="cuda") -> "ShardedEdgeVerifier":
        """Build from a step output's signatures (``out["sig"]``)."""
        return cls(out["sig"], backend=backend, batch_pairs=batch_pairs,
                   device=device)

    def drift_count(self, pairs: np.ndarray,
                    reference: BatchVerifier) -> int:
        """#pairs whose estimate differs from ``reference``'s (expect 0)."""
        pairs = np.asarray(pairs).reshape(-1, 2)
        if pairs.size == 0:
            return 0
        return int(np.sum(self(pairs) != reference(pairs)))


class DeviceScoredEdgeVerifier(ShardedEdgeVerifier):
    """Stage 2 for the device-resident verify mode (``stage2="device"``).

    The sharded step scores its edges on the device (K7, full-M
    agreement counts), and the host merge registers ``counts / M`` with
    ``add_scores``.  ``_verify_batch`` serves a pair from that registry
    when it is there and re-scores the rest with the parent's
    full-signature estimate: edges whose member row overflowed the
    cross-shard row buffer, and root pairs the engine forms after
    unions.  Both give the same float32 bits, so drift stays 0.

    ``n_passthrough`` / ``n_rescored`` count how the pairs split.
    """

    def __init__(self, signatures, backend: str = "numpy",
                 batch_pairs: int = 8192, *, device="cuda"):
        super().__init__(signatures, backend=backend,
                         batch_pairs=batch_pairs, device=device)
        self._scores: dict[tuple[int, int], float] = {}
        self.n_passthrough = 0
        self.n_rescored = 0

    def add_scores(self, pairs: np.ndarray, sims: np.ndarray) -> None:
        """Register device-computed scores; a pair (a, b) in either order
        is keyed (min, max), the engine's root-pair order."""
        pairs = np.asarray(pairs).reshape(-1, 2).astype(np.int64)
        keys = zip(pairs.min(axis=1).tolist(), pairs.max(axis=1).tolist())
        self._scores.update(zip(keys, np.asarray(sims).reshape(-1).tolist()))

    @property
    def num_scores(self) -> int:
        return len(self._scores)

    def clear_scores(self) -> None:
        """Drop the registry (the counters stay).

        A registered edge is dead once its step has been fed: it is in
        the engine's verified-sim cache, or its ends are co-clustered
        and unions never split.
        """
        self._scores.clear()

    def _verify_batch(self, pairs: np.ndarray) -> np.ndarray:
        out = np.empty(len(pairs), dtype=np.float32)
        missing = []
        missing_at = []
        for i, (a, b) in enumerate(pairs.tolist()):
            s = self._scores.get((a, b))
            if s is None:
                missing.append((a, b))
                missing_at.append(i)
            else:
                out[i] = s
        self.n_passthrough += len(pairs) - len(missing)
        if missing:
            self.n_rescored += len(missing)
            out[missing_at] = super()._verify_batch(
                np.array(missing, dtype=np.int64))
        return out


class ExactJaccardVerifier(BatchVerifier):
    """Vectorized exact Jaccard over sorted interned n-gram id arrays.

    Each document's n-gram set is interned to integer ids once, through
    a vocabulary that persists across chunks (``from_token_lists``,
    ``extend_token_lists``); a batch of P pairs is then verified by
    concatenating the two padded id rows, sorting each row, and counting
    adjacent equal values (|A ∩ B| by merge).  Matches
    ``jaccard.exact_jaccard`` on n-gram sets exactly.

    Retention: as in ``SignatureVerifier``, the first ``release_rows``
    call switches from row i == doc i to a doc -> row map with a pool of
    freed rows that later extensions fill first.
    """

    def __init__(self, id_rows: list[np.ndarray], batch_pairs: int = 2048,
                 *, _vocab: dict | None = None, _ngram: int | None = None):
        super().__init__()
        self.batch_pairs = int(batch_pairs)
        self._rows = [np.asarray(r, dtype=np.int64) for r in id_rows]
        self._vocab = _vocab  # n-gram -> id (None: raw id rows only)
        self._ngram = _ngram
        self._slots: _SlotPool | None = None  # the eviction layout
        self._n_docs = len(self._rows)
        self._rebuild()

    @staticmethod
    def _pad_rows(rows: list[np.ndarray], row0: int, lmax: int) -> np.ndarray:
        """Pad id rows to (len(rows), lmax).

        Pad slot (row0 + i, j) holds the negative sentinel
        ``-(1 + (row0 + i) * lmax + j)``: unique across the matrix and
        below every interned id, so a pad matches nothing, and it stays
        valid when later chunks grow the vocabulary (``extend_id_rows``).
        """
        d = len(rows)
        out = -(1 + np.int64(row0) * lmax
                + np.arange(d * lmax, dtype=np.int64).reshape(d, lmax))
        for i, row in enumerate(rows):
            out[i, : len(row)] = row
        return out

    def _rebuild(self) -> None:
        """Pad every row again at the current longest row's width."""
        self._n_rows = len(self._rows)
        self._len_buf = np.array([len(r) for r in self._rows], dtype=np.int64)
        self._lmax = int(max(1, self._len_buf.max(initial=1)))
        self._ids_buf = self._pad_rows(self._rows, 0, self._lmax)
        self.lengths = self._len_buf
        self.ids = self._ids_buf

    @property
    def n_live_rows(self) -> int:
        """Rows holding a retained document's n-gram ids."""
        if self._slots is None:
            return self._n_rows
        return len(self._slots.slot_of)

    def _grow(self, n1: int) -> None:
        """Capacity-double the padded buffers to hold ``n1`` rows."""
        if n1 <= len(self._ids_buf):
            return
        n0 = self._n_rows
        cap = max(n1, 2 * n0)
        ids_buf = np.empty((cap, self._lmax), dtype=np.int64)
        ids_buf[:n0] = self._ids_buf[:n0]
        len_buf = np.empty((cap,), dtype=np.int64)
        len_buf[:n0] = self._len_buf[:n0]
        self._ids_buf, self._len_buf = ids_buf, len_buf

    def extend_id_rows(self, id_rows: list[np.ndarray]) -> None:
        """Add sorted id rows, interned in this verifier's namespace.

        Capacity-doubling buffers make a chunk O(chunk) amortized while
        its rows fit the current width; a chunk holding a longer
        document than any before pads the whole matrix again.  In the
        eviction layout freed rows are filled first.
        """
        if not id_rows:
            return
        new = [np.asarray(r, dtype=np.int64) for r in id_rows]
        if self._slots is not None:
            self._extend_into_slots(new)
            return
        n0, n1 = self._n_rows, self._n_rows + len(new)
        self._rows.extend(new)
        self._n_docs = n1
        if max(len(r) for r in new) > self._lmax:
            self._rebuild()
            return
        self._grow(n1)
        self._ids_buf[n0:n1] = self._pad_rows(new, n0, self._lmax)
        self._len_buf[n0:n1] = [len(r) for r in new]
        self._n_rows = n1
        self.ids = self._ids_buf[:n1]
        self.lengths = self._len_buf[:n1]

    def _extend_into_slots(self, new: list[np.ndarray]) -> None:
        """Eviction-layout extension: fill freed rows, then append."""
        slots = self._slots.place(self._n_docs, len(new), len(self._rows)).tolist()
        self._n_docs += len(new)
        for slot, row in zip(slots, new):
            if slot < len(self._rows):
                self._rows[slot] = row
            else:
                self._rows.append(row)
        if max(len(r) for r in new) > self._lmax:
            self._rebuild()            # one full pad at the new width
            return
        n1 = len(self._rows)
        self._grow(n1)
        for slot, row in zip(slots, new):
            self._ids_buf[slot] = self._pad_rows([row], slot, self._lmax)[0]
            self._len_buf[slot] = len(row)
        self._n_rows = n1
        self.ids = self._ids_buf[:n1]
        self.lengths = self._len_buf[:n1]

    def _slot_index(self, ids) -> np.ndarray:
        """Global doc ids -> physical rows."""
        ids = np.asarray(ids, dtype=np.int64)
        if self._slots is None:
            return ids
        return self._slots.index(ids, "token")

    def release_rows(self, doc_ids) -> int:
        """Evict docs' id rows into the free-row pool.  Each doc's id array
        is dropped at once; its padded row is reused by the next
        extension."""
        if self._slots is None:
            # As in ``SignatureVerifier.release_rows``: views frozen so far
            # share these buffers, which are rewritten in place from now on.
            self._ids_buf = self._ids_buf.copy()
            self._len_buf = self._len_buf.copy()
            self.ids = self._ids_buf[: self._n_rows]
            self.lengths = self._len_buf[: self._n_rows]
            self._slots = _SlotPool(self._n_rows)
        slots = self._slots.release(doc_ids)
        for slot in slots:
            self._rows[slot] = np.zeros((0,), dtype=np.int64)
            self._len_buf[slot] = 0
        return len(slots)

    def frozen_rows(self) -> tuple[np.ndarray, np.ndarray, dict | None]:
        """(ids, lengths, doc -> row): the read path's snapshot of the rows.

        Row i == doc i (``None`` for the map): extensions write past this
        row bound or into new buffers, so the current row prefixes never
        change and are shared.  In the eviction layout freed rows are
        rewritten in place, so the rows are copied with the map.
        """
        if self._slots is None:
            return self.ids, self.lengths, None
        return self.ids.copy(), self.lengths.copy(), dict(self._slots.slot_of)

    def extend_token_lists(self, token_lists: list[list[str]]) -> None:
        """Intern new documents with the persistent vocabulary and append."""
        if self._vocab is None or self._ngram is None:
            raise ValueError(
                "verifier was built from raw id rows (no vocab); use "
                "extend_id_rows with consistently interned rows")
        self.extend_id_rows(_intern_rows(
            self._vocab, (ngram_set(t, self._ngram) for t in token_lists)))

    @classmethod
    def from_token_lists(cls, token_lists: list[list[str]], n: int = 8,
                         batch_pairs: int = 2048) -> "ExactJaccardVerifier":
        """Intern every document's n-gram set to sorted int64 id rows."""
        vocab: dict = {}
        rows = _intern_rows(vocab, (ngram_set(t, n) for t in token_lists))
        return cls(rows, batch_pairs=batch_pairs, _vocab=vocab, _ngram=n)

    @classmethod
    def from_ngram_sets(cls, ngram_sets: list[set], batch_pairs: int = 2048,
                        n: int | None = None) -> "ExactJaccardVerifier":
        """Intern pre-built n-gram sets.  ``n``, the width they were built
        with, enables ``extend_token_lists``."""
        vocab: dict = {}
        rows = _intern_rows(vocab, ngram_sets)
        return cls(rows, batch_pairs=batch_pairs, _vocab=vocab, _ngram=n)

    def _verify_batch(self, pairs: np.ndarray) -> np.ndarray:
        pairs = self._slot_index(pairs)
        a_idx, b_idx = pairs[:, 0], pairs[:, 1]
        merged = np.concatenate([self.ids[a_idx], self.ids[b_idx]], axis=1)
        merged.sort(axis=1)
        inter = np.sum(merged[:, 1:] == merged[:, :-1], axis=1)
        union = self.lengths[a_idx] + self.lengths[b_idx] - inter
        # Two empty sets have Jaccard 1.0 (matches jaccard.exact_jaccard).
        return np.where(
            union > 0, inter / np.maximum(union, 1), 1.0).astype(np.float32)


def _intern_rows(vocab: dict, ngram_sets) -> list[np.ndarray]:
    """n-gram sets -> sorted int64 id rows, new n-grams added to ``vocab``."""
    rows = []
    for s in ngram_sets:
        ids = {vocab.setdefault(g, len(vocab)) for g in s}
        rows.append(np.sort(np.fromiter(ids, dtype=np.int64, count=len(ids))))
    return rows


def as_verifier(obj) -> BatchVerifier:
    """Coerce a BatchVerifier or scalar ``fn(a, b)`` into a verifier."""
    if isinstance(obj, BatchVerifier):
        return obj
    if callable(obj):
        return CallbackVerifier(obj)
    raise TypeError(f"not a verifier or similarity fn: {obj!r}")
