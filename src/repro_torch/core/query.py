"""Online dedup read path: probe and verify over a ``SessionView``.

Port of ``repro.core.query``.  Given query documents, is each a (near)
duplicate of something already ingested, and of which cluster?

    query texts -> signatures and band values (the write path's own
    ``DedupPipeline`` stages: K1, or K6 -> compaction -> K1 for bytes)
    -> band probe against the view's frozen bucket maps
    -> batched verify of (retained doc, query) candidate pairs
    -> threshold at the engine's edge threshold.

The verify step uses the engine's estimators bit for bit: the signature
estimate ``count / M`` in float32 (host numpy, or K2's counts on the
session's device divided in PyTorch), and the merge-count exact Jaccard
for exact sessions.  So querying an ingested document reproduces the
session's recorded pair similarities.  Queries never mutate session
state: probes read the view's frozen copies, and exact-mode interning
only ``get``s from the shared vocabulary.

``serving.dedup_service.DedupQueryService`` serves this over a warm
session, with microbatching.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import minhash, sanitize
from repro_torch.core.hashing import u32_from_numpy
from repro_torch.core.session import SessionView
from repro_torch.core.shingle import ngram_set, pow2_bucket
from repro_torch.kernels import sigjaccard

BACKENDS = ("numpy", "torch", "kernel")


@dataclass(frozen=True)
class QueryResult:
    """Verdict for one query document against a ``SessionView``.

    ``is_duplicate`` uses the engine's edge rule (``sim >
    edge_threshold``); ``cluster_root`` and ``matched_doc`` are ``None``
    for novel documents.  ``candidates`` keeps every verified (retained
    doc, sim) pair, best first.  ``filter_only_hits`` counts band keys
    found only in a band's Bloom filter of compacted keys (seen before,
    by a doc the index can no longer name).
    """

    is_duplicate: bool
    cluster_root: int | None
    best_sim: float
    matched_doc: int | None
    n_candidates: int = 0
    filter_only_hits: int = 0
    candidates: tuple = ()

    @property
    def novel(self) -> bool:
        return not self.is_duplicate


def probe_candidates(
    view: SessionView, bands: np.ndarray,
) -> tuple[list[np.ndarray], list[int]]:
    """Band-probe (Q, b, 2) uint32 query band values against a view.

    Returns per-query sorted unique candidate doc ids and per-query
    Bloom-only hit counts: a key missing from a band's map that the
    band's filter holds counts one for its query.  A pure read of the
    view's frozen bucket maps and filters: nothing is inserted, no
    recency moves, and the session's own counter is untouched.

    A sqlite-tier view delegates to its store's pure Bloom-first
    ``probe_keys`` (a primary-filter miss never touches disk, the hits
    pay one batched SELECT a band), and the candidates are clipped to
    the view's ``n_docs``, so docs ingested after its publication stay
    invisible to it.  Otherwise every batch walks the host dicts, one
    ``get`` a (query, band): a device searchsorted probe lost to it at
    every batch size measured on the H100 (``chip_smoke.py`` phase H3,
    ``PERF.md``): each of its hits still needs the dict's bucket, and
    its index is rebuilt for every published view.  A band's filter is
    read for the whole batch at once.
    """
    bands = np.asarray(bands)
    if bands.ndim != 3 or bands.shape[1] != view.num_bands:
        raise ValueError(
            f"expected (Q, {view.num_bands}, 2) bands, got {bands.shape}")
    if bands.dtype != np.uint32:
        raise TypeError(f"expected uint32 band values, got {bands.dtype}")
    if view.band_store is not None:
        cands, filter_hits = view.band_store.probe_keys(bands)
        return [c[c < view.n_docs] for c in cands], filter_hits
    q = len(bands)
    cands: list[set[int]] = [set() for _ in range(q)]
    filter_hits = [0] * q
    for j, m in enumerate(view.band_maps):
        flt = view.band_filters[j]
        in_filter = flt.contains_keys(bands[:, j, :]) if flt is not None \
            else None
        for i, key in enumerate(bands[:, j, :].tolist()):
            olds = m.get(tuple(key))
            if olds is not None:
                cands[i].update(olds)
            elif in_filter is not None and in_filter[i]:
                filter_hits[i] += 1
    return [np.array(sorted(s), dtype=np.int64) for s in cands], filter_hits


class ViewVerifier:
    """Batched (retained doc, query) signature estimate over one view.

    Backends are those of ``verify.SignatureVerifier``: ``numpy`` on the
    host, ``torch`` (gather and compare) or ``kernel`` (K2's counts) on
    the view's device, each dividing counts by M correctly rounded, so
    all three give the same float32 bits.

    The device backends keep one buffer on the device: the view's
    retained rows, uploaded once per verifier, followed by room for a
    query block.  Each batch writes its query rows after the retained
    ones and gathers both sides from the one matrix by index, so no
    batch copies the retained rows again.
    """

    batch_pairs = 8192

    def __init__(self, view: SessionView, backend: str = "numpy"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        if view.mode != "estimate":
            raise ValueError("ViewVerifier needs an estimate-mode view; "
                             "use ExactViewVerifier for exact sessions")
        self.view = view
        self.backend = backend
        self._dev_buf: torch.Tensor | None = None  # [retained; query block]
        self.n_pairs = 0
        self.n_batches = 0

    def _device_stack(self, q_sigs: np.ndarray) -> torch.Tensor:
        """The (R + Q, M) device matrix [retained rows; ``q_sigs``]."""
        ret = self.view.signatures
        n_ret, q = len(ret), len(q_sigs)
        if self._dev_buf is None or len(self._dev_buf) < n_ret + q:
            buf = torch.empty((n_ret + pow2_bucket(q, floor=64), ret.shape[1]),
                              dtype=torch.int32, device=self.view.device)
            if self._dev_buf is None:
                buf[:n_ret] = u32_from_numpy(ret, self.view.device)
            else:
                buf[:n_ret] = self._dev_buf[:n_ret]
            self._dev_buf = buf
        self._dev_buf[n_ret : n_ret + q] = u32_from_numpy(q_sigs,
                                                          self.view.device)
        return self._dev_buf[: n_ret + q]

    def sims(self, q_sigs: np.ndarray, cand_ids: np.ndarray,
             q_idx: np.ndarray) -> np.ndarray:
        """sims[p] = estimate(retained row of cand_ids[p], q_sigs[q_idx[p]])."""
        cand_ids = np.asarray(cand_ids, dtype=np.int64)
        q_idx = np.asarray(q_idx, dtype=np.int64)
        if cand_ids.size == 0:
            return np.zeros((0,), dtype=np.float32)
        q_sigs = np.asarray(q_sigs, dtype=np.uint32)
        stack = None if self.backend == "numpy" else self._device_stack(q_sigs)
        out = np.empty(len(cand_ids), dtype=np.float32)
        for s in range(0, len(cand_ids), self.batch_pairs):
            c = cand_ids[s : s + self.batch_pairs]
            qi = q_idx[s : s + self.batch_pairs]
            out[s : s + len(c)] = self._sims_batch(q_sigs, stack, c, qi)
            self.n_batches += 1
        self.n_pairs += len(cand_ids)
        return out

    def _sims_batch(self, q_sigs, stack, cand_ids, q_idx) -> np.ndarray:
        view = self.view
        if self.backend == "numpy":
            a = view.rows_for(cand_ids)
            b = q_sigs[q_idx]
            return (a == b).mean(axis=-1, dtype=np.float32)
        n_ret = len(view.signatures)
        block = torch.from_numpy(np.stack(
            [view.slot_index(cand_ids), n_ret + q_idx])).to(stack.device)
        a, b = block[0], block[1]
        if self.backend == "torch":
            est = minhash.estimate_jaccard(stack[a], stack[b])
        else:
            est = minhash.estimate_from_counts(
                sigjaccard.pair_counts(stack, a, b), stack.shape[1])
        return est.cpu().numpy()


class ExactViewVerifier:
    """Exact-Jaccard query verifier over a view's frozen token rows.

    Query n-grams are interned read-only against the session's shared
    vocabulary (``dict.get`` only).  An n-gram the vocabulary has never
    seen intersects no stored row, so it counts toward the union only;
    ``inter / union`` is divided in float64 and cast to float32 as in
    ``verify.ExactJaccardVerifier``.
    """

    def __init__(self, view: SessionView):
        if view.exact is None:
            raise ValueError("view has no exact token rows; "
                             "use ViewVerifier for estimate sessions")
        self.view = view
        self.n_pairs = 0
        self.n_batches = 0

    def intern_queries(
        self, token_lists: list[list[str]]
    ) -> tuple[list[np.ndarray], np.ndarray]:
        """Per-query (known-id row, total n-gram count incl. unknown)."""
        ex = self.view.exact
        vocab = ex.vocab
        rows, totals = [], []
        for toks in token_lists:
            grams = ngram_set(toks, ex.ngram)
            ids = [vocab.get(g) for g in grams]
            rows.append(np.sort(np.array(
                [i for i in ids if i is not None], dtype=np.int64)))
            totals.append(len(grams))
        return rows, np.asarray(totals, dtype=np.int64)

    def sims(self, q_rows: list[np.ndarray], q_totals: np.ndarray,
             cand_ids: np.ndarray, q_idx: np.ndarray) -> np.ndarray:
        ex = self.view.exact
        cand_ids = np.asarray(cand_ids, dtype=np.int64)
        q_idx = np.asarray(q_idx, dtype=np.int64)
        if cand_ids.size == 0:
            return np.zeros((0,), dtype=np.float32)
        inter = np.empty(len(cand_ids), dtype=np.int64)
        la = np.empty(len(cand_ids), dtype=np.int64)
        for p, (doc, qi) in enumerate(zip(cand_ids, q_idx)):
            stored = ex.row_for(int(doc))
            la[p] = len(stored)
            inter[p] = np.intersect1d(
                stored, q_rows[int(qi)], assume_unique=True).size
        union = la + q_totals[q_idx] - inter
        self.n_pairs += len(cand_ids)
        self.n_batches += 1
        # Two empty sets have Jaccard 1.0 (matches ExactJaccardVerifier).
        return np.where(
            union > 0, inter / np.maximum(union, 1), 1.0).astype(np.float32)


def _flatten(cands: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Per-query candidate lists -> flat (cand_ids, q_idx) pair arrays."""
    if not any(len(c) for c in cands):
        e = np.zeros((0,), dtype=np.int64)
        return e, e
    cand_ids = np.concatenate([c for c in cands if len(c)])
    q_idx = np.concatenate([np.full(len(c), i, dtype=np.int64)
                            for i, c in enumerate(cands) if len(c)])
    return cand_ids, q_idx


def query_view(
    view: SessionView,
    bands: np.ndarray,
    *,
    sig: np.ndarray | None = None,
    token_lists: list[list[str]] | None = None,
    backend: str = "numpy",
    verifier=None,
) -> list[QueryResult]:
    """Probe and verify one query batch against a view.

    ``bands`` (Q, b, 2) uint32 drives the probe; verifying needs ``sig``
    (Q, M) uint32 for estimate-mode views or ``token_lists`` for
    exact-mode views (both from the write path's stages,
    ``DedupPipeline.compute_arrays`` and ``tokenize``).  Pass a cached
    ``ViewVerifier`` / ``ExactViewVerifier`` as ``verifier`` to reuse
    its device buffer across calls (the service does).

    With ``REPRO_SANITIZE=1`` the view's arrays are fingerprinted and
    checked again on entry and exit (``sanitize.SessionViewMutated``).
    """
    sanitize.check_view(view, "query entry")
    cands, filter_hits = probe_candidates(view, bands)
    cand_ids, q_idx = _flatten(cands)
    if view.mode == "estimate":
        if sig is None:
            raise ValueError("estimate-mode query needs sig (Q, M)")
        v = verifier if verifier is not None else ViewVerifier(
            view, backend=backend)
        sims = v.sims(sig, cand_ids, q_idx)
    else:
        if token_lists is None:
            raise ValueError("exact-mode query needs token_lists")
        v = verifier if verifier is not None else ExactViewVerifier(view)
        q_rows, q_totals = v.intern_queries(token_lists)
        sims = v.sims(q_rows, q_totals, cand_ids, q_idx)

    out: list[QueryResult] = []
    start = 0
    for i, c in enumerate(cands):
        s = sims[start : start + len(c)]
        start += len(c)
        if len(c) == 0:
            out.append(QueryResult(
                is_duplicate=False, cluster_root=None, best_sim=0.0,
                matched_doc=None, n_candidates=0,
                filter_only_hits=filter_hits[i]))
            continue
        order = np.lexsort((c, -s.astype(np.float64)))
        ranked = tuple((int(c[k]), float(s[k])) for k in order)
        best_doc, best_sim = ranked[0]
        # The engine's edge rule: float32 sim against the config's float.
        dup = bool(s[order[0]] > view.edge_threshold)
        out.append(QueryResult(
            is_duplicate=dup,
            cluster_root=view.root_of(best_doc) if dup else None,
            best_sim=best_sim,
            matched_doc=best_doc if dup else None,
            n_candidates=len(c),
            filter_only_hits=filter_hits[i],
            candidates=ranked))
    sanitize.check_view(view, "query exit")
    return out
