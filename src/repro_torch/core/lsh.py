"""Banded locality-sensitive hashing (paper §4; port of ``repro.core.lsh``).

The (D, M) signature matrix is cut into b bands of r rows, and each
band's r values fold into one value per document, kept as two
independent 32-bit lanes (about 64-bit discrimination, as the paper's
64-bit band values).  Documents sharing a band value in at least one
band are candidates: P(candidate) = 1 - (1 - s^r)^b.  ``sort_band``,
``run_heads`` and ``star_edges`` are the sort-based candidate runs of
one band as tensor functions.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.hashing import as_u32, hash_u32, to_bits

# Per-lane fold seeds (arbitrary distinct constants).
LANE_SEEDS = (0x2545F491, 0x9E3779B9)


def sort_band(vals: torch.Tensor, doc_ids: torch.Tensor):
    """Sort one band's (value_hi, value_lo, doc) triples by value.

    ``vals`` (D, 2) int32 words, ``doc_ids`` (D,) int32.  Returns the
    sorted (vals (D, 2), docs (D,)), lexicographic on the unsigned lanes;
    equal values keep their input order.
    """
    order = torch.sort(as_u32(vals[:, 1]), stable=True).indices
    order = order[torch.sort(as_u32(vals[order, 0]), stable=True).indices]
    return vals[order], doc_ids[order]


def run_heads(sorted_vals: torch.Tensor) -> torch.Tensor:
    """Boolean mask: position starts a new equal-value run."""
    same = (sorted_vals[1:] == sorted_vals[:-1]).all(dim=-1)
    first = torch.ones(1, dtype=torch.bool, device=sorted_vals.device)
    return torch.cat([first, ~same])


def star_edges(sorted_vals: torch.Tensor, sorted_docs: torch.Tensor):
    """Candidate edges (run head -> doc) of one sorted band.

    Returns (edges (D, 2) int32, mask (D,) bool): edge i joins the first
    doc of i's run to ``sorted_docs[i]``; the mask is False at run heads
    (no self edge).  O(D) edges, with the same connected components as
    the paper's all-pairs enumeration.
    """
    heads = run_heads(sorted_vals)
    idx = torch.arange(sorted_docs.shape[0], device=sorted_docs.device)
    head_idx = torch.cummax(torch.where(heads, idx, 0), dim=0).values
    edges = torch.stack([sorted_docs[head_idx], sorted_docs], dim=-1)
    return edges.to(torch.int32), ~heads


def candidate_probability(s, r: int, b: int) -> torch.Tensor:
    """P(candidate | Jaccard=s) = 1 - (1 - s^r)^b  (paper §4.4)."""
    s = torch.as_tensor(s, dtype=torch.float64)
    return 1.0 - (1.0 - s**r) ** b


def band_values(sig: torch.Tensor, r: int) -> torch.Tensor:
    """Fold the (D, M) signature matrix into the (D, M/r, 2) band matrix.

    Per lane: h = lane seed, then h <- fmix32(h * GOLDEN32 + sig row) over
    the band's r rows.  Returns int32 bits.
    """
    D, M = sig.shape
    if M % r:
        raise ValueError(f"M={M} not divisible by r={r}")
    s = as_u32(sig).reshape(D, M // r, r)
    lanes = []
    for lane_seed in LANE_SEEDS:
        h = torch.full((D, M // r), lane_seed, dtype=torch.int64,
                       device=sig.device)
        for k in range(r):
            h = hash_u32(h, s[:, :, k])
        lanes.append(h)
    return to_bits(torch.stack(lanes, dim=-1))


@dataclass(frozen=True)
class LSHParams:
    """Paper defaults: M=100, r=2, b=50, n=8 (paper §7.2, §9.1)."""

    num_hashes: int = 100
    rows_per_band: int = 2
    ngram: int = 8

    @property
    def num_bands(self) -> int:
        return self.num_hashes // self.rows_per_band

    def threshold_estimate(self) -> float:
        """Approximate similarity threshold (1/b)^(1/r)."""
        return float((1.0 / self.num_bands) ** (1.0 / self.rows_per_band))
