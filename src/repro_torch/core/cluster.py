"""Clustering driver: the paper §6.5 ``find_candidate_pairs`` procedure.

Port of ``repro.core.cluster``: a thin driver over the staged engine
(``engine.cluster_source``), ``CandidateSource -> BatchVerifier ->
ThresholdUnionFind``.  Pairs whose endpoints already share a root are
*excluded* from Jaccard evaluation, the paper's headline saving (Table
5).  ``modularity`` needs ``networkx``, imported when called.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.candidates import BandMatrixSource
from repro_torch.core.engine import ClusterStats, cluster_source
from repro_torch.core.unionfind import ThresholdUnionFind
from repro_torch.core.verify import BatchVerifier

__all__ = ["ClusterStats", "cluster_bands", "modularity"]


def cluster_bands(
    bands: np.ndarray,
    similarity_fn: Callable[[int, int], float] | BatchVerifier,
    edge_threshold: float,
    tree_threshold: float,
    use_disjoint_sets: bool = True,
    *,
    batch: str = "run",
    max_batch_pairs: int = 8192,
) -> tuple[ThresholdUnionFind, ClusterStats, list[tuple[int, int, float]]]:
    """Run paper §6.5 over an in-memory band matrix.

    bands: (D, b, 2) uint32 band matrix.
    similarity_fn: a ``verify.BatchVerifier`` (batched, preferred) or a
    scalar ``fn(a_doc, b_doc) -> exact Jaccard`` callable (wrapped).
    Returns (union-find, stats, evaluated_pairs [(a, b, sim), ...]).

    With ``use_disjoint_sets=False`` every candidate pair is evaluated
    (the paper's non-clustered baseline used for Table 5's "6388 pairs").
    See ``engine.cluster_source`` for the ``batch`` granularity knob.
    """
    return cluster_source(
        BandMatrixSource(bands),
        similarity_fn,
        edge_threshold,
        tree_threshold,
        use_disjoint_sets=use_disjoint_sets,
        batch=batch,
        max_batch_pairs=max_batch_pairs,
    )


def modularity(
    labels: np.ndarray, pairs: list[tuple[int, int, float]]
) -> float:
    """Weighted modularity Q (paper §10, Newman 2006) of a clustering.

    Edge weights are the Jaccard similarities of the evaluated pairs.
    """
    import networkx as nx

    g = nx.Graph()
    g.add_nodes_from(range(len(labels)))
    for a, b, s in pairs:
        if s > 0:
            g.add_edge(a, b, weight=s)
    if g.number_of_edges() == 0:
        return 0.0
    comms: dict[int, set] = {}
    for i, l in enumerate(labels):
        comms.setdefault(int(l), set()).add(i)
    return nx.community.modularity(g, list(comms.values()), weight="weight")
