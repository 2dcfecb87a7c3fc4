"""K1: fused ingest -- packed tokens -> (signatures, band values, validity).

One pass computes the whole signature chain: rolling n-gram hash, seeded
minhash minimum, two-lane band fold.  ``fused_ingest`` launches the CUDA
kernel (``csrc/fused_ingest.cu``) for tensors on the card and runs
``fused_ingest_plain``, the same function as plain PyTorch, for tensors
on the CPU.  The two agree bit for bit.

The kernel's lane map (``csrc/fused_ingest.cu``): a block of ``threads``
lanes takes ``docs`` rows; a lane keeps S seeds in registers, ``lanes`` =
ceil(M / S) lanes cover the seeds (in ``passes`` rounds where that
exceeds the block), and the block's ``slices`` groups of lanes share the
quads of the rows' n-gram hashes; a row longer than the pool is walked
in rounds of ``tile`` positions.  ``schedule`` asks the library for
that choice.

Words are uint32 carried as int32 bits (``core.hashing``): tokens (D, L),
seeds (M,), signatures (D, M) and band values (D, M/r, 2) are int32
tensors; lengths are int32; validity is bool.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.lsh import band_values
from repro_torch.core.minhash import signatures
from repro_torch.core.shingle import ngram_hashes
from repro_torch.kernels import build

# Kernel launches made by ``fused_ingest`` in this process.
launches = 0

MAP_KEYS = ("threads", "S", "lanes", "passes", "slices", "docs", "tile")


def schedule(M: int, L: int) -> dict:
    """The lane map the built kernel takes for rows of L tokens and M
    seeds (``fused_ingest_schedule``), keyed by ``MAP_KEYS``."""
    out = (ctypes.c_int32 * len(MAP_KEYS))()
    build.check_launch(build.library().fused_ingest_schedule(
        M, L, ctypes.addressof(out)), "fused_ingest_schedule")
    return dict(zip(MAP_KEYS, out))


def fused_ingest_plain(tokens: torch.Tensor, lengths: torch.Tensor,
                       seeds: torch.Tensor, *, n: int = 8, r: int = 2):
    """Plain PyTorch version: the staged n-gram -> minhash -> fold chain."""
    ng, valid = ngram_hashes(tokens, lengths, n=n)
    sig = signatures(ng, valid, seeds)
    return sig, band_values(sig, r), valid


def fused_ingest(tokens: torch.Tensor, lengths: torch.Tensor,
                 seeds: torch.Tensor, *, n: int = 8, r: int = 2):
    """(D, L) tokens, (D,) lengths, (M,) seeds ->
    ((D, M) signatures, (D, M//r, 2) band values, (D, L) validity).

    Tensors on a CUDA device go through the kernel; tensors on the CPU
    through ``fused_ingest_plain``.
    """
    global launches
    if tokens.dim() != 2 or lengths.shape != (tokens.shape[0],) \
            or seeds.dim() != 1:
        raise ValueError(f"bad shapes: tokens {tuple(tokens.shape)}, "
                         f"lengths {tuple(lengths.shape)}, seeds "
                         f"{tuple(seeds.shape)}")
    for name, t in (("tokens", tokens), ("lengths", lengths),
                    ("seeds", seeds)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != tokens.device:
            raise ValueError(f"{name} is on {t.device}, tokens on "
                             f"{tokens.device}")
    D, L = tokens.shape
    M = seeds.shape[0]
    if L < 1 or M < 1 or n < 1 or r < 1 or M % r:
        raise ValueError(f"need L, M, n, r >= 1 and M % r == 0 "
                         f"(L={L}, M={M}, n={n}, r={r})")
    if tokens.device.type == "cpu":
        return fused_ingest_plain(tokens, lengths, seeds, n=n, r=r)
    if tokens.device.type != "cuda":
        raise ValueError(f"no kernel for device {tokens.device}")
    tokens, lengths, seeds = (t.contiguous() for t in (tokens, lengths, seeds))
    sig = torch.empty((D, M), dtype=torch.int32, device=tokens.device)
    bands = torch.empty((D, M // r, 2), dtype=torch.int32, device=tokens.device)
    valid = torch.empty((D, L), dtype=torch.bool, device=tokens.device)
    if D == 0:
        return sig, bands, valid
    lib = build.library()
    with torch.cuda.device(tokens.device):
        code = lib.fused_ingest_launch(
            tokens.data_ptr(), lengths.data_ptr(), seeds.data_ptr(),
            sig.data_ptr(), bands.data_ptr(), valid.data_ptr(), D, L, M, n, r,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "fused_ingest")
    launches += 1
    return sig, bands, valid
