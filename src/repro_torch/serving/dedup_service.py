"""Online dedup query service over a warm ``DedupSession``.

Port of ``repro.serving.dedup_service``.  ``DedupQueryService`` holds a
long-lived session, reads its published ``SessionView`` and answers

    query(texts) -> [QueryResult(is_duplicate, cluster_root,
                                 best_sim, matched_doc)]

without mutating session state, plus ``admit(texts)`` to ingest
documents (after which the next query sees a fresh view).

Two calling styles:

* synchronous: ``query(texts)`` runs one batch end to end;
* microbatched: ``submit`` / ``step`` / ``run_until_drained``, the slot
  and queue shape of ``serving.engine.ServeEngine``: each ``step``
  drains up to ``max_batch`` queued documents and runs one signature
  pass, one probe and one batched verify for all of them.  The results
  equal sequential queries.

On the session's device the signature pass is K1 (``query``,
``query_tokens``) or K6 -> compaction -> K1 (``query_bytes``), and the
``kernel`` verify backend is K2.  The per-view verifier is cached by
view version, so the retained rows go to the device once a publication.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from repro_torch.core import shingle
from repro_torch.core.pipeline import DedupPipeline
from repro_torch.core.query import (
    ExactViewVerifier,
    QueryResult,
    ViewVerifier,
    query_view,
)
from repro_torch.core.session import ClusterSnapshot, DedupSession, SessionView


@dataclass
class QueryRequest:
    """One enqueued query document (microbatched path)."""

    rid: int
    tokens: list[str]
    result: QueryResult | None = None
    enqueued_at: float = 0.0
    latency_s: float = 0.0
    done: bool = False


@dataclass
class QueryServiceStats:
    queries: int = 0
    microbatches: int = 0
    batch_occupancy_sum: float = 0.0
    admitted: int = 0
    duplicates_found: int = 0

    @property
    def mean_occupancy(self) -> float:
        """Mean microbatch fill fraction (of ``max_batch``)."""
        return self.batch_occupancy_sum / max(1, self.microbatches)


class DedupQueryService:
    """Low-latency "is this note a duplicate?" API over a warm session.

    ``backend`` picks the verify estimator of estimate-mode sessions
    (``numpy``, ``torch`` or ``kernel``; default: the session config's
    ``resolved_backend()``); exact-mode sessions always verify with the
    exact merge-count Jaccard.  The query stages run on the session's
    device.
    """

    def __init__(self, session: DedupSession, *, backend: str | None = None,
                 max_batch: int = 64):
        self.session = session
        self.backend = backend or session.config.resolved_backend()
        self.max_batch = int(max_batch)
        # The same config and seeds as the session, so a query's
        # signatures and bands are those ingesting it would compute.
        self.pipe = DedupPipeline(session.config, device=session.device)
        self.pipe.seeds = session.seeds
        self.queue: deque[QueryRequest] = deque()
        self.stats = QueryServiceStats()
        self._rid = 0
        self._verifier = None
        self._verifier_version = -1

    # -- read path -----------------------------------------------------------

    def view(self) -> SessionView:
        """The session's current published view (cached until ingest)."""
        return self.session.view()

    def _verifier_for(self, view: SessionView):
        if self._verifier is not None and \
                self._verifier_version == view.version:
            return self._verifier
        if view.mode == "exact":
            self._verifier = ExactViewVerifier(view)
        else:
            self._verifier = ViewVerifier(view, backend=self.backend)
        self._verifier_version = view.version
        return self._verifier

    def query(self, texts: list[str]) -> list[QueryResult]:
        """Answer one batch of query documents synchronously."""
        if self.session.config.byte_ingest:
            # Byte sessions tokenize on the device, without stemming; the
            # host tokenizer would stem and miss the ingested rows.
            return self.query_bytes(texts)
        return self.query_tokens([self.pipe.tokenize([t])[0] for t in texts])

    def query_bytes(self, texts: list[str | bytes]) -> list[QueryResult]:
        """``query`` straight from UTF-8 bytes (K6 -> compaction -> K1).

        Equal to querying ``tokenize(text, do_stem=False)`` tokens, so the
        results match ``byte_ingest`` sessions.  Exact-mode views have no
        byte route (exact Jaccard needs host token lists).
        """
        if not texts:
            return []
        view = self.view()
        if view.mode == "exact":
            raise ValueError(
                "query_bytes serves estimate-mode views only; exact "
                "Jaccard verification needs host token lists; use "
                "query()/query_tokens() against this session")
        n = len(texts)
        raw = [t if isinstance(t, bytes) else t.encode("utf-8")
               for t in texts]
        # Power-of-two widths, as _bucketed_arrays (the +1 keeps the
        # final token's end column; see shingle.pack_bytes).
        lb = shingle.pow2_bucket(max(len(b) for b in raw) + 1)
        db = shingle.pow2_bucket(n, floor=8)
        padded = raw + [b"pad"] * (db - n)
        sig, bands = self.pipe.compute_arrays_bytes(padded, pad_len=lb)
        results = query_view(view, bands[:n], sig=sig[:n],
                             verifier=self._verifier_for(view))
        self.stats.queries += len(results)  # repro-lint: disable=RPR002
        self.stats.duplicates_found += sum(  # repro-lint: disable=RPR002
            r.is_duplicate for r in results)
        return results

    def query_tokens(
        self, token_lists: list[list[str]]
    ) -> list[QueryResult]:
        """``query`` over pre-tokenized documents."""
        if not token_lists:
            return []
        view = self.view()
        sig, bands = self._bucketed_arrays(token_lists)
        results = query_view(view, bands, sig=sig, token_lists=token_lists,
                             verifier=self._verifier_for(view))
        # Telemetry counters only: no query reads them, so the purity
        # contract (RPR002) holds for everything queries observe.
        self.stats.queries += len(results)  # repro-lint: disable=RPR002
        self.stats.duplicates_found += sum(  # repro-lint: disable=RPR002
            r.is_duplicate for r in results)
        return results

    def _bucketed_arrays(self, token_lists):
        """Query-batch (sig, bands), both dimensions padded to powers of
        two as the reference does to bound its jit compiles (signatures
        do not depend on padding); the pad rows are dropped."""
        n = len(token_lists)
        lb = shingle.pow2_bucket(max(len(t) for t in token_lists))
        db = shingle.pow2_bucket(n, floor=8)
        padded = list(token_lists) + [["pad"]] * (db - n)
        sig, bands = self.pipe.compute_arrays(padded, pad_len=lb)
        return sig[:n], bands[:n]

    # -- write path ----------------------------------------------------------

    def admit(self, texts: list[str]) -> ClusterSnapshot:
        """Ingest documents into the session (the write path).

        The next ``view()`` publishes a fresh view covering them; queries
        holding the old view keep its frozen state.
        """
        snap = self.session.ingest(list(texts))
        self.stats.admitted = snap.n_docs
        return snap

    # -- microbatching (continuous-batching shape) ---------------------------

    def submit(self, text: str) -> int:
        """Enqueue one query document; returns its request id."""
        self._rid += 1
        # Byte sessions match the device tokenizer (no stemming); the
        # token path over those tokens gives query_bytes's signatures.
        toks = (shingle.tokenize(text, do_stem=False)
                if self.session.config.byte_ingest
                else self.pipe.tokenize([text])[0])
        self.queue.append(QueryRequest(
            self._rid, toks, enqueued_at=time.perf_counter()))
        return self._rid

    def step(self) -> int:
        """Serve one microbatch: drain up to ``max_batch`` queued queries
        and run one signature pass, probe and batched verify for all of
        them.  Returns the number of queries served."""
        if not self.queue:
            return 0
        batch: list[QueryRequest] = []
        while self.queue and len(batch) < self.max_batch:
            batch.append(self.queue.popleft())
        results = self.query_tokens([r.tokens for r in batch])
        now = time.perf_counter()
        for req, res in zip(batch, results):
            req.result = res
            req.latency_s = now - req.enqueued_at
            req.done = True
        self.stats.microbatches += 1
        self.stats.batch_occupancy_sum += len(batch) / self.max_batch
        return len(batch)

    def run_until_drained(self,
                          max_steps: int = 10_000) -> list[QueryRequest]:
        """Step until the queue is empty; returns finished requests."""
        finished: list[QueryRequest] = []
        pending: dict[int, QueryRequest] = {r.rid: r for r in self.queue}
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
            for rid, r in list(pending.items()):
                if r.done:
                    finished.append(r)
                    del pending[rid]
        return finished
