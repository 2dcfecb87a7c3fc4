"""The staged dedup engine: CandidateSource -> BatchVerifier -> UnionFind.

Port of ``repro.core.engine`` (host code): the paper's §6.5
``find_candidate_pairs`` procedure.  For each band the engine walks
equal-value runs, path-compresses run members to their current
union-find roots, and collects not-yet-evaluated root pairs into a
buffer that is flushed through the verifier in batches.

``batch`` granularity:

* ``"run"`` (default) -- flush at every run boundary.  Unions from one
  run are visible to the next run's root compression, so the exclusion
  statistics (paper Table 5) and the union-find lower-bound guarantee
  are those of the paper's scalar loop.
* ``"band"`` -- flush at band boundaries (or when the buffer reaches
  ``max_batch_pairs``).  Larger batches; pairs that a same-band union
  would have excluded may be evaluated, and a union's ``sim`` is the one
  measured against collection-time roots, so the tree-threshold
  guarantee becomes approximate.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.candidates import CandidateSource
from repro_torch.core.unionfind import ThresholdUnionFind
from repro_torch.core.verify import as_verifier


@dataclass
class ClusterStats:
    """Engine counters (superset of the paper's Table 5 accounting)."""

    pairs_generated: int = 0
    pairs_evaluated: int = 0
    pairs_excluded: int = 0  # skipped Jaccard computations (paper Table 5)
    pairs_above_edge: int = 0
    unions_done: int = 0
    unions_rejected: int = 0
    verify_batches: int = 0
    verify_seconds: float = 0.0

    @property
    def verify_pairs_per_second(self) -> float:
        if self.verify_seconds <= 0:
            return 0.0
        return self.pairs_evaluated / self.verify_seconds

    def add(self, other: "ClusterStats") -> "ClusterStats":
        """Accumulate another pass's counters (multi-source clustering)."""
        for f in (
            "pairs_generated", "pairs_evaluated", "pairs_excluded",
            "pairs_above_edge", "unions_done", "unions_rejected",
            "verify_batches", "verify_seconds",
        ):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self


class ClusterAccumulator:
    """Incremental multi-source clustering: one union-find, shared caches.

    ``feed`` drives one candidate source through batched verification
    into the accumulator's union-find.  The verified-sim cache carries
    across feeds: a pair evaluated in one feed is counted as *excluded*
    (never re-verified) when a later feed emits it again, exactly like
    re-occurrences within a single source.

    ``stats`` holds the totals across every feed; each ``feed`` call
    also returns that source's own ``ClusterStats``.

    ``grow`` extends the union-find to cover newly allocated doc ids, and
    ``feed(source, verifier=...)`` overrides the verifier for one feed
    while the verified-sim cache and union-find stay shared.
    ``DedupPipeline.run`` feeds one ``BandMatrixSource`` into one
    accumulator.
    """

    def __init__(
        self,
        num_docs: int,
        verifier,
        edge_threshold: float,
        tree_threshold: float,
        *,
        use_disjoint_sets: bool = True,
        batch: str = "run",
        max_batch_pairs: int = 8192,
        uf: ThresholdUnionFind | None = None,
    ):
        if batch not in ("run", "band"):
            raise ValueError(f"unknown batch granularity {batch!r}")
        self.verifier = as_verifier(verifier)
        if uf is None:
            uf = ThresholdUnionFind(num_docs, tree_threshold)
        else:
            if len(uf.parent) < num_docs:
                raise ValueError(
                    f"existing uf covers {len(uf.parent)} docs, source "
                    f"has {num_docs}")
            if uf.tree_threshold != tree_threshold:
                raise ValueError(
                    f"tree_threshold {tree_threshold} does not match the "
                    f"existing uf's {uf.tree_threshold}; unions are "
                    "guarded by the uf's own threshold")
        self.uf = uf
        self.edge_threshold = float(edge_threshold)
        self.use_disjoint_sets = bool(use_disjoint_sets)
        self.batch = batch
        self.max_batch_pairs = int(max_batch_pairs)
        self.stats = ClusterStats()
        self.evaluated: dict[tuple[int, int], float] = {}

    @property
    def pairs(self) -> list[tuple[int, int, float]]:
        """Every evaluated (a, b, sim), sorted, across all feeds."""
        return [(a, b, s) for (a, b), s in sorted(self.evaluated.items())]

    @property
    def num_docs(self) -> int:
        return len(self.uf.parent)

    def grow(self, num_docs: int) -> None:
        """Extend the union-find to cover ``num_docs`` ids (no-op if it
        already does).  New ids start as singletons."""
        self.uf.grow(num_docs)

    def feed(self, source: CandidateSource,
             verifier=None) -> ClusterStats:
        """Cluster one source into the accumulator; returns its stats.

        ``verifier`` overrides the accumulator's verifier for THIS feed
        only (same shared sim cache / union-find / stats).
        """
        if len(self.uf.parent) < source.num_docs:
            raise ValueError(
                f"accumulator covers {len(self.uf.parent)} docs, source "
                f"has {source.num_docs}")
        uf = self.uf
        verifier = (self.verifier if verifier is None
                    else as_verifier(verifier))
        evaluated = self.evaluated
        # Snapshot the verifier's lifetime counters so stats report THIS
        # feed's batches/seconds even when the verifier instance is
        # reused (e.g. re-clustering at a second threshold).
        batches0, seconds0 = verifier.n_batches, verifier.seconds
        stats = ClusterStats()
        pending: list[tuple[int, int]] = []
        pending_set: set[tuple[int, int]] = set()

        def flush():
            if not pending:
                return
            sims = verifier(np.array(pending, dtype=np.int64))
            for (a, c), sim in zip(pending, sims):
                sim = float(sim)
                evaluated[(a, c)] = sim
                stats.pairs_evaluated += 1
                if sim > self.edge_threshold:
                    stats.pairs_above_edge += 1
                    if self.use_disjoint_sets:
                        before = uf.n_unions
                        uf.union(a, c, sim)
                        if uf.n_unions > before:
                            stats.unions_done += 1
                        else:
                            stats.unions_rejected += 1
            pending.clear()
            pending_set.clear()

        for band_runs in source.iter_bands():
            for members in band_runs.iter_groups():
                m = len(members)
                stats.pairs_generated += m * (m - 1) // 2
                if self.use_disjoint_sets:
                    # "replace D with D.find()" — compress to roots.
                    uniq = np.unique([uf.find(int(d)) for d in members])
                else:
                    uniq = np.sort(members)
                k = len(uniq)
                if k < 2:
                    # All members already co-clustered: all excluded.
                    stats.pairs_excluded += m * (m - 1) // 2
                    continue
                # Pairs collapsed by prior clustering are excluded too.
                stats.pairs_excluded += m * (m - 1) // 2 - k * (k - 1) // 2
                for ii in range(k):
                    for jj in range(ii + 1, k):
                        key = (int(uniq[ii]), int(uniq[jj]))
                        if key in evaluated or key in pending_set:
                            stats.pairs_excluded += 1
                            continue
                        pending.append(key)
                        pending_set.add(key)
                if self.batch == "run" or \
                        len(pending) >= self.max_batch_pairs:
                    flush()
            if self.batch == "band":
                flush()
        flush()

        stats.verify_batches = verifier.n_batches - batches0
        stats.verify_seconds = verifier.seconds - seconds0
        self.stats.add(stats)
        return stats


def cluster_source(
    source: CandidateSource,
    verifier,
    edge_threshold: float,
    tree_threshold: float,
    *,
    use_disjoint_sets: bool = True,
    batch: str = "run",
    max_batch_pairs: int = 8192,
    uf: ThresholdUnionFind | None = None,
) -> tuple[ThresholdUnionFind, ClusterStats, list[tuple[int, int, float]]]:
    """Run the staged engine over a candidate source.

    ``verifier`` is a ``verify.BatchVerifier`` or a scalar
    ``fn(a, b) -> float`` (wrapped via ``verify.as_verifier``).
    Returns (union-find, stats, evaluated_pairs [(a, b, sim), ...]).

    With ``use_disjoint_sets=False`` every candidate pair is evaluated
    (the paper's non-clustered baseline behind Table 5's "6388 pairs").

    Passing an existing ``uf`` accumulates this source's clustering into
    it instead of starting fresh: docs already co-clustered by a previous
    pass are excluded up front.  For feeding several sources with a
    shared verified-sim cache, use ``ClusterAccumulator`` directly.
    """
    acc = ClusterAccumulator(
        source.num_docs, verifier, edge_threshold, tree_threshold,
        use_disjoint_sets=use_disjoint_sets, batch=batch,
        max_batch_pairs=max_batch_pairs, uf=uf)
    stats = acc.feed(source)
    return acc.uf, stats, acc.pairs


def merge_cluster_rounds(
    uf: ThresholdUnionFind,
    verifier,
    edge_threshold: float,
    *,
    max_batch_pairs: int = 8192,
    roots=None,
    candidate_pairs=None,
    sim_cache: dict | None = None,
) -> int:
    """Paper §10's second clustering round, batch-verified.

    Compares cluster REPRESENTATIVES and merges clusters whose reps are
    highly similar (fixes the over-partitioning the disjoint-set pass can
    produce — Table 7's 56 'diff-set high-similarity' pairs).  The (i, j)
    sweep is processed in blocks of ``max_batch_pairs``: each block's
    still-distinct current-root pairs go through the verifier in one
    dispatch, then the block's merges are applied in sweep order (rare
    pairs whose roots changed mid-block fall back to a singleton
    dispatch).  The verified-sim cache (``sim_at``) is shared across
    blocks: a doc pair's similarity is deterministic, so a root pair
    that re-appears in a later block reuses the cached value.  Sims are
    always between *current* roots at union time.  Returns #merges.

    * ``roots`` — explicit representative candidates (any docs; each is
      compressed to its current root) instead of a scan of all docs.
    * ``candidate_pairs`` — (E, 2) doc-id pairs to sweep INSTEAD of the
      full (i, j) cross product (e.g. band collisions among re-banded
      representatives); each endpoint is compressed to its current root
      at processing time, so chained merges behave exactly like the
      full sweep restricted to those pairs.
    * ``sim_cache`` — external ``{(a, b): sim}`` dict shared with the
      caller (for example an accumulator's verified-sim cache): sims
      already verified are never re-dispatched, and sims this round
      computes become visible to the caller.
    """
    verifier = as_verifier(verifier)
    if candidate_pairs is not None:
        cand = np.asarray(candidate_pairs, dtype=np.int64).reshape(-1, 2)
        if len(cand) == 0:
            return 0
        sweep = [(int(a), int(b)) for a, b in cand]
    else:
        if roots is None:
            roots = range(len(uf.parent))
        roots = sorted({uf.find(int(r)) for r in roots})
        if len(roots) < 2:
            return 0
        sweep = None  # generated lazily below (O(R^2) pairs)

    def blocks():
        block = []
        if sweep is not None:
            for a, b in sweep:
                block.append((a, b))
                if len(block) >= max_batch_pairs:
                    yield block
                    block = []
        else:
            for i in range(len(roots)):
                for j in range(i + 1, len(roots)):
                    block.append((roots[i], roots[j]))
                    if len(block) >= max_batch_pairs:
                        yield block
                        block = []
        if block:
            yield block

    merges = 0
    sim_at = sim_cache if sim_cache is not None else {}
    for block in blocks():
        want = []
        want_set = set()
        for x, y in block:
            a, b = uf.find(x), uf.find(y)
            key = (min(a, b), max(a, b))
            if a != b and key not in sim_at and key not in want_set:
                want_set.add(key)
                want.append(key)
        if want:
            for key, s in zip(want, verifier(np.array(want,
                                                      dtype=np.int64))):
                sim_at[key] = float(s)
        for x, y in block:
            a, b = uf.find(x), uf.find(y)
            if a == b:
                continue
            key = (min(a, b), max(a, b))
            sim = sim_at.get(key)
            if sim is None:
                # Roots changed due to a union earlier in this block.
                sim = float(verifier(np.array([key], dtype=np.int64))[0])
                sim_at[key] = sim
            if sim > edge_threshold and uf.union(a, b, sim):
                merges += 1
    return merges
