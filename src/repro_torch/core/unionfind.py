"""Disjoint sets with a Jaccard lower-bound guarantee (paper §6).

Port of ``repro.core.unionfind``: ``ThresholdUnionFind`` (host numpy
code), ``connected_components`` (in torch) and
``cluster_min_score_audit``.
Every tree carries ``min_score``, the minimum triangle-inequality lower
bound on Jaccard similarity between the root and any leaf.  A union of
two trees is admitted only when the implied leaf-to-leaf bound

    leaf_to_leaf = x.min_score + y.min_score + sim(xRoot, yRoot) - 2

stays >= ``tree_threshold`` (paper §6.4), so every pair of documents in
one cluster has Jaccard >= tree_threshold.
"""
from __future__ import annotations

import numpy as np
import torch


class ThresholdUnionFind:
    """Paper §6.4 extended disjoint sets (host-side, numpy-backed)."""

    def __init__(self, n: int, tree_threshold: float):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int32)
        # min lower bound on Jaccard between node (as root) and its leaves.
        self.min_score = np.ones(n, dtype=np.float64)
        self.tree_threshold = float(tree_threshold)
        self.n_unions = 0
        self.n_rejected = 0
        # With ``track_deposed`` on, each union logs the root it deposed
        # (a doc loses roothood at most once), so an eviction policy can
        # find newly non-representative docs without scanning all docs.
        self.track_deposed = False
        self.deposed: list[int] = []

    def grow(self, n: int) -> None:
        """Extend the forest to cover ``n`` docs (new ids are singletons)."""
        old = len(self.parent)
        if n <= old:
            return
        self.parent = np.concatenate(
            [self.parent, np.arange(old, n, dtype=np.int64)])
        self.rank = np.concatenate(
            [self.rank, np.zeros(n - old, dtype=np.int32)])
        self.min_score = np.concatenate(
            [self.min_score, np.ones(n - old, dtype=np.float64)])

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        # Path compression (min_score is only meaningful at roots).
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return int(root)

    def union(self, x: int, y: int, sim: float) -> bool:
        """Union by rank, guarded by the lower-bound threshold property.

        ``sim`` is the similarity between the two current roots'
        documents.  Returns True iff the union was performed.
        """
        x_root, y_root = self.find(x), self.find(y)
        if x_root == y_root:
            return False
        leaf_to_leaf = (
            self.min_score[x_root] + self.min_score[y_root] + sim - 2.0)
        if leaf_to_leaf < self.tree_threshold:
            self.n_rejected += 1
            return False
        if self.rank[x_root] < self.rank[y_root]:
            x_root, y_root = y_root, x_root
        # Attach y under x.
        self.parent[y_root] = x_root
        if self.track_deposed:
            self.deposed.append(int(y_root))
        if self.rank[x_root] == self.rank[y_root]:
            self.rank[x_root] += 1
        self.min_score[x_root] = min(
            self.min_score[x_root], self.min_score[y_root] - (1.0 - sim))
        self.n_unions += 1
        return True

    def drain_deposed(self) -> list[int]:
        """Return (and clear) the roots deposed since the last drain."""
        out, self.deposed = self.deposed, []
        return out

    def components(self) -> np.ndarray:
        """Root label for every node (fully compressed)."""
        return np.array([self.find(i) for i in range(len(self.parent))])

    def clusters(self, min_size: int = 2) -> list[list[int]]:
        roots = self.components()
        groups: dict[int, list[int]] = {}
        for i, r in enumerate(roots):
            groups.setdefault(int(r), []).append(i)
        return [v for v in groups.values() if len(v) >= min_size]


# -- parallel connected components and their audit -------------------------------

_INT32_MAX = 2**31 - 1


def connected_components(edges: torch.Tensor, mask: torch.Tensor,
                         num_nodes: int) -> torch.Tensor:
    """Connected-component labels of an edge list: the least node id
    reachable from each node.

    ``edges`` (E, 2) int32, ``mask`` (E,) bool (masked edges ignored).
    Returns (num_nodes,) int32.  Each round hooks both ends of every
    edge to the edge's least label (a scatter-min) and then shortcuts
    twice by pointer doubling, until nothing changes or 64 rounds ran,
    as the reference's ``lax.while_loop``.
    """
    u = torch.where(mask, edges[:, 0], 0).long()
    v = torch.where(mask, edges[:, 1], 0).long()
    labels = torch.arange(num_nodes, dtype=torch.int32, device=edges.device)
    for _ in range(64):
        m = torch.where(mask, torch.minimum(labels[u], labels[v]),
                        _INT32_MAX)
        new = labels.scatter_reduce(0, u, m, reduce="amin")
        new = new.scatter_reduce(0, v, m, reduce="amin")
        new = new[new.long()]
        new = new[new.long()]
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def cluster_min_score_audit(
    labels: np.ndarray,
    edges: np.ndarray,
    sims: np.ndarray,
    tree_threshold: float,
) -> dict:
    """Post-hoc audit of the lower-bound property of parallel CC output.

    Builds a maximum-similarity spanning tree per cluster from the
    verified edges and checks the triangle-inequality bound along tree
    paths.  Returns {n_clusters, n_audited_pairs, min_bound,
    property_holds}.  Host code on ``networkx``, imported here only.
    """
    import networkx as nx

    g = nx.Graph()
    g.add_nodes_from(range(len(labels)))
    for (a, b), s in zip(edges, sims):
        a, b = int(a), int(b)
        if a != b:
            if not g.has_edge(a, b) or g[a][b]["sim"] < s:
                g.add_edge(a, b, sim=float(s), dist=1.0 - float(s))
    min_bound = 1.0
    n_pairs = 0
    holds = True
    for comp in nx.connected_components(g):
        comp = list(comp)
        if len(comp) < 2:
            continue
        tree = nx.minimum_spanning_tree(g.subgraph(comp), weight="dist")
        ecc_dist = dict(nx.all_pairs_dijkstra_path_length(tree, weight="dist"))
        for a in comp:
            for b in comp:
                if a < b:
                    bound = 1.0 - ecc_dist[a][b]
                    min_bound = min(min_bound, bound)
                    n_pairs += 1
                    if bound < tree_threshold - 1e-9:
                        holds = False
    return {
        "n_clusters": sum(1 for c in nx.connected_components(g)
                          if len(c) >= 2),
        "n_audited_pairs": n_pairs,
        "min_bound": min_bound,
        "property_holds": holds,
    }
