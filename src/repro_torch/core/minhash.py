"""MinHash signatures (paper §3; port of ``repro.core.minhash``).

sig[d, m] = min over the document's valid n-gram hashes x of
hash_u32(x, seed[m]); the Jaccard estimate of two documents is the share
of signature entries on which they agree (paper §3.3-3.4).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import U32_MAX, as_u32, hash_u32, make_seeds, to_bits


def signatures(
    ngrams: torch.Tensor,
    valid: torch.Tensor,
    seeds: torch.Tensor,
    m_chunk: int = 16,
) -> torch.Tensor:
    """MinHash signature matrix.

    ngrams: (D, L) uint32 words; valid: (D, L) bool; seeds: (M,) words.
    Returns (D, M) int32 bits; a document with no valid position gets
    U32_MAX everywhere.  Seeds are processed ``m_chunk`` at a time, so
    the extra memory is one (D, L, m_chunk) int64 block.
    """
    ng = as_u32(ngrams)[:, :, None]
    sd = as_u32(seeds)
    out = torch.empty((ng.shape[0], sd.shape[0]), dtype=torch.int64,
                      device=ng.device)
    for s in range(0, sd.shape[0], m_chunk):
        h = hash_u32(ng, sd[None, None, s : s + m_chunk])
        h = torch.where(valid[:, :, None], h, U32_MAX)
        out[:, s : s + m_chunk] = h.amin(dim=1)
    return to_bits(out)


def estimate_from_counts(counts: torch.Tensor, m: int) -> torch.Tensor:
    """Agreement counts -> float32 estimate counts / m, correctly rounded.

    The divisor is a full tensor on the counts' device: PyTorch divides
    by a Python scalar on the card as a multiply by its reciprocal,
    which lands 1 ulp off for some counts (40/100 among them).  The
    result equals numpy's ``(a == b).mean(axis=-1, dtype=np.float32)``
    bit for bit.
    """
    c = counts.to(torch.float32)
    return c / torch.full_like(c, float(m))


def estimate_jaccard(sig_a: torch.Tensor, sig_b: torch.Tensor) -> torch.Tensor:
    """Signature-agreement Jaccard estimate m/M over the last axis."""
    counts = (sig_a == sig_b).sum(dim=-1, dtype=torch.int32)
    return estimate_from_counts(counts, sig_a.shape[-1])


def default_seeds(m: int = 100) -> np.ndarray:
    return make_seeds(m)
