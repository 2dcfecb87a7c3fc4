"""32-bit hash family on torch tensors (port of ``repro.core.hashing``).

The family is built from the Murmur3 finalizer ``fmix32``, a bijection
on uint32, seeded by an odd multiply and an add.  Every operation is
uint32 arithmetic with wraparound.

Carrier convention.  ``torch.uint32`` on the CPU lacks ``>>``, ``+`` and
``min``, so the port carries uint32 words two ways:

* at function boundaries, as ``int32`` tensors holding the same 32 bits
  (``to_bits``; ``u32_from_numpy`` / ``u32_to_numpy`` move them to and
  from numpy ``uint32`` without copying bits around);
* inside arithmetic, as ``int64`` tensors with values in ``[0, 2**32)``
  (``as_u32``), masked with ``& MASK32`` after each multiply.

Multiplies go through ``mul32``, which splits the 32-bit constant into
16-bit halves so that no int64 product exceeds 2**49: signed overflow
never happens, on the CPU or on the card.
"""
from __future__ import annotations

import numpy as np
import torch

# Murmur3 finalizer constants.
_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35
# Knuth multiplicative constant (odd -> bijective multiply mod 2^32).
GOLDEN32 = 0x9E3779B9
# Polynomial base for rolling n-gram hashes (the FNV prime, odd).
NGRAM_BASE = 0x01000193
U32_MAX = 0xFFFFFFFF
# FNV-1a parameters of the host token-id hash.
FNV_OFFSET32 = 2166136261
FNV_PRIME32 = 16777619

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
_SIGN32 = 0x80000000


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 words of an integer tensor as int64 values in [0, 2**32)."""
    return x.to(torch.int64) & MASK32


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32 bits."""
    x = as_u32(x)
    # Values with bit 31 set map to x - 2**32, which int32 holds exactly.
    return (x - ((x & _SIGN32) << 1)).to(torch.int32)


def u32_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor with the same bits."""
    bits = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(bits).to(device)


def u32_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of uint32 words -> numpy uint32 array."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 word tensor, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.uint32)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant."""
    lo = x * (c & _MASK16)
    hi = ((x * (c >> 16)) & _MASK16) << 16
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer: bijective avalanche on uint32 (int64 result)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = mul32(x, _FMIX_C1)
    x = x ^ (x >> 13)
    x = mul32(x, _FMIX_C2)
    return x ^ (x >> 16)


def hash_u32(x: torch.Tensor, seed) -> torch.Tensor:
    """Seeded hash h_seed(x) = fmix32(x * GOLDEN32 + seed) (int64 result).

    ``seed`` is an int or an integer tensor that broadcasts against x.
    """
    if isinstance(seed, torch.Tensor):
        seed = as_u32(seed)
    else:
        seed = int(seed) & MASK32
    return fmix32((mul32(as_u32(x), GOLDEN32) + seed) & MASK32)


def make_seeds(m: int, key: int = 0x5EED) -> np.ndarray:
    """M deterministic 32-bit seeds, the same as ``repro``'s for one key."""
    rng = np.random.RandomState(key & 0x7FFFFFFF)
    return rng.randint(0, 2**32, size=(m,), dtype=np.uint64).astype(np.uint32)
