"""Jaccard similarity: exact and signature-estimated (paper §2.1, §3.3)."""
from __future__ import annotations

import torch

from repro_torch.core.minhash import estimate_jaccard
from repro_torch.core.shingle import ngram_set


def exact_jaccard(a: set, b: set) -> float:
    """Exact set Jaccard |A∩B| / |A∪B| (paper §2.1)."""
    if not a and not b:
        return 1.0
    inter = len(a & b)
    union = len(a) + len(b) - inter
    return inter / union if union else 0.0


def exact_jaccard_docs(tokens_a: list[str], tokens_b: list[str],
                       n: int = 8) -> float:
    return exact_jaccard(ngram_set(tokens_a, n), ngram_set(tokens_b, n))


def pairwise_estimate(sig: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """Signature-agreement estimate for candidate pairs.

    sig: (D, M) words; pairs: (P, 2) int.  Returns (P,) float32.
    """
    return estimate_jaccard(sig[pairs[:, 0]], sig[pairs[:, 1]])
